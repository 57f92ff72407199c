"""Bayesian online changepoint detection (BOCPD, Adams & MacKay 2007).

The reference's streaming story is "set the observation signal, sweep"
(``/root/reference/test/inference_engine_tests.jl:348-351``); its conjugate
test algebra (``/root/reference/test/runtests.jl:17-101``) is exactly the
machinery BOCPD composes online: at every step the *run-length* posterior
p(r_t | y_1:t) is propagated with conjugate predictive likelihoods and a
constant hazard.

Design: the run-length axis is **statically truncated** to
``r_max`` so the whole filter is one ``lax.scan`` over time with
``(..., r_max)``-shaped state — per-step work is a handful of fused
elementwise ops plus one ``logsumexp``, batching over replicas in the
leading axes.  No data-dependent shapes, no host round-trips.

Observation families (both conjugate, per run-length hypothesis):

- :class:`GaussianNIG` — unknown mean & variance, Normal-Inverse-Gamma
  prior, Student-t predictive;
- :class:`BernoulliBeta` — unknown rate, Beta prior, Beta-Bernoulli
  predictive (the reference's coin-toss algebra, online).

Truncation: run lengths ≥ ``r_max - 1`` accumulate in the last bin.  Mass is
merged exactly (``logaddexp``); the bin's sufficient statistics follow the
higher-mass branch — if the "stayed" hypothesis dominates, the bin keeps its
own updated statistics (the standard "old regime" approximation), otherwise
it adopts the newly-arrived run's statistics.  With ``r_max > T`` the filter
is exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.special import gammaln

__all__ = ["BOCPD", "GaussianNIG", "BernoulliBeta", "BOCPDResult"]


@dataclasses.dataclass(frozen=True)
class GaussianNIG:
    """Normal-Inverse-Gamma conjugate observation model.

    Posterior after n observations: standard NIG recursions; predictive is
    Student-t.  Sufficient statistics are accumulated *centered at the prior
    mean* — ``(n, Σ(y−μ0), Σ(y−μ0)²)`` — so ``beta`` below is a sum of
    near-positive terms; raw ``(Σy, Σy²)`` accumulation catastrophically
    cancels in float32 once ``|mean|/std ≳ 1e3`` over long runs.
    """

    mu0: float = 0.0
    kappa0: float = 1.0
    alpha0: float = 1.0
    beta0: float = 1.0

    def init_stats(self, shape, dtype):
        z = jnp.zeros(shape, dtype)
        return (z, z, z)  # (n, Σ(y−μ0), Σ(y−μ0)²)

    def update_stats(self, stats, y):
        n, s, q = stats
        yc = y[..., None] - self.mu0
        return (n + 1.0, s + yc, q + yc * yc)

    def pred_logpdf(self, stats, y):
        n, s, q = stats
        y = y[..., None]
        kappa = self.kappa0 + n
        delta = s / kappa  # = mu − mu0; division-safe (kappa ≥ kappa0 > 0)
        mu = self.mu0 + delta
        alpha = self.alpha0 + 0.5 * n
        # beta0 + 0.5(q̃ − s̃²/n) + kappa0·n·(s̃/n)²/(2κ) simplifies, in the
        # centered statistics, to beta0 + 0.5(q̃ − s̃·δ) — each term ≥ 0
        # (Cauchy–Schwarz: s̃²/κ ≤ s̃²/n ≤ q̃), so no cancellation.
        beta = self.beta0 + 0.5 * (q - s * delta)
        # Student-t(2*alpha, mu, beta*(kappa+1)/(alpha*kappa)) log pdf.
        nu = 2.0 * alpha
        scale2 = beta * (kappa + 1.0) / (alpha * kappa)
        z2 = (y - mu) ** 2 / scale2
        return (
            gammaln(0.5 * (nu + 1.0))
            - gammaln(0.5 * nu)
            - 0.5 * jnp.log(nu * jnp.pi * scale2)
            - 0.5 * (nu + 1.0) * jnp.log1p(z2 / nu)
        )


@dataclasses.dataclass(frozen=True)
class BernoulliBeta:
    """Beta-Bernoulli conjugate observation model (y ∈ {0, 1})."""

    a0: float = 1.0
    b0: float = 1.0

    def init_stats(self, shape, dtype):
        z = jnp.zeros(shape, dtype)
        return (z, z)  # (#ones, #zeros)

    def update_stats(self, stats, y):
        ones, zeros = stats
        y = y[..., None]
        return (ones + y, zeros + (1.0 - y))

    def pred_logpdf(self, stats, y):
        ones, zeros = stats
        y = y[..., None]
        p1 = (self.a0 + ones) / (self.a0 + self.b0 + ones + zeros)
        return jnp.where(y > 0.5, jnp.log(p1), jnp.log1p(-p1))


class BOCPDResult(NamedTuple):
    """Outputs per time step (leading axes = replica batch, then T)."""

    run_length_logprobs: jax.Array  # (..., T, r_max): log p(r_t | y_1:t)
    # p(r_t <= 1 | y_1:t): the run began within the last two steps.  Note
    # p(r_t = 0) alone is *identically the hazard* under a constant-hazard
    # prior (growth and change share the same predictive factor), so the
    # earliest data-driven evidence of a change appears in the r = 1 bin.
    changepoint_prob: jax.Array  # (..., T)
    log_evidence: jax.Array  # (...,): log p(y_1:T)
    map_run_length: jax.Array  # (..., T): argmax_r p(r_t | y_1:t)


@dataclasses.dataclass(frozen=True)
class BOCPD:
    """Online changepoint filter with constant hazard ``1/expected_run``.

    ``obs_model`` supplies conjugate sufficient-statistic recursions and the
    posterior-predictive log pdf; ``r_max`` is the static truncation of the
    run-length axis.
    """

    obs_model: Union[GaussianNIG, BernoulliBeta] = GaussianNIG()
    hazard: float = 0.01
    r_max: int = 256

    def filter(self, y: jax.Array) -> BOCPDResult:
        """Filter ``y`` of shape ``(..., T)``; returns run-length posteriors."""
        y = jnp.asarray(y)
        yT = jnp.moveaxis(y, -1, 0)  # (T, ...batch)
        batch_shape = yT.shape[1:]
        dtype = jnp.result_type(y.dtype, jnp.float32)
        R = self.r_max

        log_h = jnp.log(jnp.asarray(self.hazard, dtype))
        log_1mh = jnp.log1p(-jnp.asarray(self.hazard, dtype))
        neg_inf = jnp.asarray(-jnp.inf, dtype)

        # r_0 = 0 with probability 1.
        logw0 = jnp.full(batch_shape + (R,), neg_inf, dtype)
        logw0 = logw0.at[..., 0].set(0.0)
        stats0 = self.obs_model.init_stats(batch_shape + (R,), dtype)

        def step(carry, y_t):
            logw, stats, log_Z = carry
            pred = self.obs_model.pred_logpdf(stats, y_t.astype(dtype))
            joint = logw + pred  # log p(r_{t-1}, y_1:t)

            # Growth: r -> r+1 (last bin absorbs overflow mass).
            grow = joint + log_1mh
            shifted = jnp.concatenate(
                [jnp.full(batch_shape + (1,), neg_inf, dtype), grow[..., :-1]],
                axis=-1,
            )
            shifted = shifted.at[..., -1].set(
                jnp.logaddexp(shifted[..., -1], grow[..., -1])
            )
            # Changepoint: all mass routes to r = 0.
            change = jax.scipy.special.logsumexp(joint + log_h, axis=-1)
            log_joint = shifted.at[..., 0].set(change)

            step_Z = jax.scipy.special.logsumexp(log_joint, axis=-1)
            new_logw = log_joint - step_Z[..., None]

            # Sufficient statistics follow the same shift: bin r+1 inherits
            # bin r updated with y_t; bin 0 resets to the prior.  The merged
            # last bin takes the higher-mass branch's statistics: its own
            # updated stats when the "stayed ≥ r_max−1" hypothesis dominates
            # (the old-regime approximation), else the shifted-in run's.
            upd = self.obs_model.update_stats(stats, y_t.astype(dtype))
            fresh = self.obs_model.init_stats(batch_shape + (R,), dtype)
            keep_last = grow[..., -1] > grow[..., -2]
            new_stats = tuple(
                jnp.concatenate(
                    [f[..., :1], u[..., :-1]], axis=-1
                ).at[..., -1].set(
                    jnp.where(keep_last, u[..., -1], u[..., -2])
                )
                for f, u in zip(fresh, upd)
            )
            return (new_logw, new_stats, log_Z + step_Z), (new_logw,)

        (_, _, log_Z), (logws,) = lax.scan(
            step, (logw0, stats0, jnp.zeros(batch_shape, dtype)), yT
        )
        logws = jnp.moveaxis(logws, 0, -2)  # (..., T, R)
        return BOCPDResult(
            run_length_logprobs=logws,
            changepoint_prob=jnp.exp(logws[..., 0]) + jnp.exp(logws[..., 1]),
            log_evidence=log_Z,
            map_run_length=jnp.argmax(logws, axis=-1),
        )
