"""Hidden Markov model: forward-backward smoothing + Dirichlet VMP learning.

BASELINE.md config: "Hidden Markov model — discrete forward-backward +
Dirichlet VMP".  State marginals come from sum-product sweeps on the chain
(:mod:`cortex_tpu.ops.hmm`); the transition matrix (and optionally the
categorical emission matrix) carries a Dirichlet posterior updated by
variational message passing:

    E-step:  forward-backward under θ̃ = exp(E_q[log θ])  (digamma means)
    M-step:  α_post = α_prior + expected transition/emission counts

The ELBO is tracked in closed form: for conjugate structured VMP,
``ELBO = log Z̃ − Σ KL(q(θ_row) ‖ p(θ_row))`` — the free-energy reduction the
reference never had (SURVEY.md §5 "no Bethe free energy"), vectorized across
replicas and reducible with ``psum`` on a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import digamma, gammaln

from ..dists import Dirichlet
from ..ops.hmm import HMMPosterior, hmm_forward_backward, hmm_viterbi

# The one-hot contractions below are sums of probabilities over every step:
# a GPU's default (TF32) matmul moves the Dirichlet counts by ~7e-4.
_HIGHEST = lax.Precision.HIGHEST

__all__ = ["HMM", "HMMVMPState", "HMMVMPResult"]


def _dirichlet_kl(alpha_q: jax.Array, alpha_p: jax.Array) -> jax.Array:
    """KL(Dir(alpha_q) ‖ Dir(alpha_p)) along the last axis."""
    a0q = jnp.sum(alpha_q, axis=-1)
    a0p = jnp.sum(alpha_p, axis=-1)
    return (
        gammaln(a0q)
        - jnp.sum(gammaln(alpha_q), axis=-1)
        - gammaln(a0p)
        + jnp.sum(gammaln(alpha_p), axis=-1)
        + jnp.sum(
            (alpha_q - alpha_p) * (digamma(alpha_q) - digamma(a0q)[..., None]),
            axis=-1,
        )
    )


class HMMVMPState(NamedTuple):
    trans_alpha: jax.Array  # (..., K, K) Dirichlet posterior rows over A
    emis_alpha: Optional[jax.Array]  # (..., K, M) or None (fixed emissions)


class HMMVMPResult(NamedTuple):
    state: HMMVMPState
    posterior: HMMPosterior
    elbo: jax.Array  # (...,) per replica, final iteration


@dataclasses.dataclass(frozen=True)
class HMM:
    """Discrete HMM with K hidden states.

    ``log_pi``: initial log-distribution, shape (K,).  Emissions either fixed
    (pass per-step log-likelihoods to :meth:`smooth`) or categorical over M
    symbols with a Dirichlet posterior (use :meth:`fit_vmp` with integer
    observations).
    """

    K: int
    log_pi: jax.Array

    # -- sum-product smoothing with known parameters -----------------------
    def smooth(
        self,
        log_lik: jax.Array,
        log_A: jax.Array,
        method: str = "scan",
        interpret: bool = False,
    ) -> HMMPosterior:
        """Forward-backward state marginals given per-step log-likelihoods.

        ``method="pallas"`` routes through the fused scaled GPU kernel
        (requires ``log_lik`` of shape ``(R, T, K)``); results come back in
        the same log-space :class:`HMMPosterior` container.  ``interpret``
        runs that kernel in the Pallas interpreter (off a GPU it must be
        passed).
        """
        if method == "pallas":
            from ..ops.pallas_hmm import hmm_forward_backward_counts_pallas

            if log_lik.ndim != 3:
                raise ValueError(
                    "method='pallas' requires log_lik of shape (R, T, K)"
                )
            out = hmm_forward_backward_counts_pallas(
                jnp.exp(log_lik), jnp.exp(log_A), jnp.exp(self.log_pi),
                interpret=interpret,
            )
            tiny = jnp.asarray(1e-30, log_lik.dtype)
            return HMMPosterior(
                jnp.log(out.gamma + tiny),
                jnp.log(out.xi_sum + tiny),
                out.log_evidence,
            )
        return hmm_forward_backward(log_lik, log_A, self.log_pi)

    def viterbi(self, log_lik: jax.Array, log_A: jax.Array) -> jax.Array:
        return hmm_viterbi(log_lik, log_A, self.log_pi)

    # -- Dirichlet VMP over transitions (+ categorical emissions) ----------
    def fit_vmp(
        self,
        obs: jax.Array,
        n_symbols: int,
        n_iterations: int = 20,
        trans_prior: float = 1.0,
        emis_prior: float = 1.0,
        init_state: Optional[HMMVMPState] = None,
        method: str = "scan",
        pooled: bool = False,
        interpret: bool = False,
    ) -> HMMVMPResult:
        """Variational EM with Dirichlet posteriors over the transition rows
        and the categorical emission rows.

        ``obs``: integer observations ``(..., T)`` in ``[0, n_symbols)``.
        Missing steps are encoded as ``-1``: the one-hot row is all-zero, so
        the step contributes a uniform (zero log-) likelihood to the E-step
        and nothing to the emission counts — the exact marginalization;
        leading axes are independent replicas, each with its own posterior.
        Runs as a ``lax.scan`` over iterations — one jittable program.

        ``pooled=True`` learns ONE shared posterior from all replicas
        (expected counts summed across the batch) — the classic
        many-sequences-one-model setup; otherwise each replica carries its
        own posterior.

        ``method``: "scan" (log-space forward-backward) or "pallas" (the
        fused scaled GPU kernel emitting marginals + pairwise counts;
        requires ``pooled=True`` with obs of shape ``(R, T)``, since the
        kernel holds one shared transition matrix).  ``interpret`` runs
        that kernel in the Pallas interpreter (off a GPU it must be
        passed).
        """
        obs = jnp.asarray(obs)
        K, M = self.K, n_symbols
        batch = () if pooled else obs.shape[:-1]
        onehot = jax.nn.one_hot(obs, M)  # (..., T, M)
        if method == "pallas" and not (pooled and obs.ndim == 2):
            raise ValueError(
                "method='pallas' requires pooled=True and obs of shape (R, T)"
            )

        if init_state is None:
            # Symmetry breaking: tilt the transition prior towards
            # self-persistence (deterministic, replica-independent).
            eye = jnp.eye(K)
            trans_alpha = jnp.broadcast_to(
                trans_prior + 0.5 * eye, batch + (K, K)
            )
            emis_alpha = jnp.broadcast_to(
                emis_prior
                + 0.25
                * jax.nn.one_hot(jnp.arange(K) % M, M),
                batch + (K, M),
            )
            init_state = HMMVMPState(trans_alpha, emis_alpha)

        trans_prior_arr = jnp.full((K, K), trans_prior)
        emis_prior_arr = jnp.full((K, M), emis_prior)

        def e_step(log_lik, log_A):
            if method == "pallas":
                from ..ops.pallas_hmm import hmm_forward_backward_counts_pallas

                out = hmm_forward_backward_counts_pallas(
                    jnp.exp(log_lik), jnp.exp(log_A), jnp.exp(self.log_pi),
                    interpret=interpret,
                )
                return out.gamma, out.xi_sum, out.log_evidence
            post = hmm_forward_backward(log_lik, log_A, self.log_pi)
            return jnp.exp(post.log_gamma), jnp.exp(post.log_xi_sum), post.log_evidence

        def vmp_iter(state: HMMVMPState, _):
            # E[log θ] under the Dirichlet posteriors (digamma means).
            log_A = Dirichlet(state.trans_alpha).mean_log()
            log_B = Dirichlet(state.emis_alpha).mean_log()
            # Per-step log-likelihoods under E[log B].
            log_lik = jnp.einsum(
                "...tm,...km->...tk", onehot, log_B, precision=_HIGHEST
            )
            gamma, trans_counts, log_evidence = e_step(log_lik, log_A)
            emis_counts = jnp.einsum(
                "...tk,...tm->...km", gamma, onehot, precision=_HIGHEST
            )
            if pooled and obs.ndim > 1:
                # Sum expected statistics across replicas (one shared model).
                reduce_axes = tuple(range(obs.ndim - 1))
                trans_counts = jnp.sum(trans_counts, axis=reduce_axes)
                emis_counts = jnp.sum(emis_counts, axis=reduce_axes)
                log_evidence = jnp.sum(log_evidence, axis=reduce_axes)
            new_state = HMMVMPState(
                trans_prior_arr + trans_counts,
                emis_prior_arr + emis_counts,
            )
            elbo = (
                log_evidence
                - jnp.sum(_dirichlet_kl(new_state.trans_alpha, trans_prior_arr), axis=-1)
                - jnp.sum(_dirichlet_kl(new_state.emis_alpha, emis_prior_arr), axis=-1)
            )
            return new_state, elbo

        final_state, elbos = lax.scan(
            vmp_iter, init_state, None, length=n_iterations
        )
        # Final smoothing pass under the final posterior.
        log_A = Dirichlet(final_state.trans_alpha).mean_log()
        log_B = Dirichlet(final_state.emis_alpha).mean_log()
        log_lik = jnp.einsum(
                "...tm,...km->...tk", onehot, log_B, precision=_HIGHEST
            )
        post = hmm_forward_backward(log_lik, log_A, self.log_pi)
        return HMMVMPResult(final_state, post, elbos[-1])
