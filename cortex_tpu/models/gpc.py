"""Gaussian-process classification via parallel EP (probit likelihood).

The nonparametric counterpart of :class:`cortex_tpu.models.EPClassifier`:
the latent function gets a GP prior, EP sites are moment-matched in closed
form (Rasmussen & Williams §3.6, Algorithm 3.5 — here the *parallel* variant:
every site updates at once per iteration, one n×n Cholesky each), and the
predictive class probability integrates the latent Gaussian through the
probit exactly.  With a linear kernel this reduces to Bayesian linear probit
classification — pinned against `EPClassifier` in the tests.

All hot steps are batched matmuls + one Cholesky per iteration (matmul-bound);
the EP loop is a ``lax.scan`` under ``jit``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.stats import norm

from ..ops.ep import probit_tilted_moments
from .gp import _KERNELS

__all__ = ["GPClassifier", "GPCPosterior"]


class GPCPosterior(NamedTuple):
    """Converged EP site parameters plus the predictive closure."""

    site_tau: jax.Array
    site_nu: jax.Array
    latent_mean: jax.Array  # (n,) posterior mean of f at the training inputs
    predict_fn: Callable
    site_delta: jax.Array

    def latent(self, Xs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Latent predictive ``q(f*) = N(μ*, σ*²)`` at ``(m, d)`` inputs."""
        return self.predict_fn(Xs)

    def predict_proba(self, Xs: jax.Array) -> jax.Array:
        """``p(y=+1 | x*)`` — exact probit integral over the latent."""
        mu, var = self.predict_fn(Xs)
        return norm.cdf(mu / jnp.sqrt(1.0 + var))

    def predict(self, Xs: jax.Array) -> jax.Array:
        """Hard labels in {-1, +1}."""
        return jnp.where(self.predict_proba(Xs) >= 0.5, 1.0, -1.0)


@dataclasses.dataclass(frozen=True)
class GPClassifier:
    """Binary GP classification ``y ∈ {-1,+1}``, ``p(y|f) = Φ(y f)``,
    ``f ~ GP(0, k)``.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``/``"linear"``)
    or a callable ``k(a, b, lengthscale, variance)``.
    """

    kernel: str | Callable = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    n_iters: int = 40
    damping: float = 0.7
    jitter: float = 1e-6

    def _k(self):
        if self.kernel == "linear":
            return lambda a, b: self.variance * (a @ b.T)
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def fit(self, X: jax.Array, y: jax.Array) -> GPCPosterior:
        """``X``: ``(n, d)``; ``y``: ``(n,)`` in {-1, +1}."""
        X = jnp.atleast_2d(jnp.asarray(X))
        y = jnp.asarray(y)
        n = X.shape[0]
        k = self._k()
        K = k(X, X) + self.jitter * (1.0 + self.variance) * jnp.eye(n, dtype=X.dtype)
        tilted = probit_tilted_moments(y)
        tau_floor = 1e-8

        def posterior(tau, nu):
            # Σ = K − K√τ B⁻¹ √τ K with B = I + √τ K √τ (RW eq. 3.56).
            sq = jnp.sqrt(tau)
            B = jnp.eye(n, dtype=X.dtype) + sq[:, None] * K * sq[None, :]
            L = jnp.linalg.cholesky(B)
            V = jax.scipy.linalg.solve_triangular(L, sq[:, None] * K, lower=True)
            Sigma_diag = jnp.diagonal(K) - jnp.sum(V * V, axis=0)
            mu = K @ nu - V.T @ (V @ nu)
            return mu, Sigma_diag, L, V

        def step(state, _):
            tau, nu = state
            mu, sd, _, _ = posterior(tau, nu)
            tau_cav = jnp.maximum(1.0 / sd - tau, tau_floor)
            nu_cav = mu / sd - nu
            mu_cav = nu_cav / tau_cav
            var_cav = 1.0 / tau_cav
            mt, vt = tilted(mu_cav, var_cav)
            vt = jnp.maximum(vt, 1e-10)
            tau_new = jnp.maximum(1.0 / vt - tau_cav, tau_floor)
            nu_new = mt / vt - nu_cav
            tau_next = (1.0 - self.damping) * tau + self.damping * tau_new
            nu_next = (1.0 - self.damping) * nu + self.damping * nu_new
            delta = jnp.maximum(
                jnp.max(jnp.abs(tau_next - tau)), jnp.max(jnp.abs(nu_next - nu))
            )
            return (tau_next, nu_next), delta

        init = (jnp.full((n,), tau_floor, X.dtype), jnp.zeros((n,), X.dtype))
        (tau, nu), deltas = lax.scan(step, init, None, length=self.n_iters)
        mu, _, L, _ = posterior(tau, nu)

        # Predictive (RW eq. 3.60-3.61): f̄* = k*ᵀ(K+Σ̃)⁻¹μ̃ with μ̃=ν̃/τ̃,
        # computed through the same B factorization:
        #   (K+Σ̃)⁻¹μ̃ = ν̃ − √τ B⁻¹ √τ K ν̃.
        sq = jnp.sqrt(tau)
        z = sq * jax.scipy.linalg.cho_solve((L, True), sq * (K @ nu))
        alpha = nu - z  # (n,)

        def predict(Xs):
            Xs = jnp.atleast_2d(jnp.asarray(Xs))
            Ks = k(X, Xs)  # (n, m)
            mean = Ks.T @ alpha
            V = jax.scipy.linalg.solve_triangular(L, sq[:, None] * Ks, lower=True)
            if isinstance(self.kernel, str) and self.kernel == "linear":
                kss = self.variance * jnp.sum(Xs * Xs, axis=-1)
            elif isinstance(self.kernel, str):
                kss = jnp.full((Xs.shape[0],), self.variance, X.dtype)
            else:
                kss = jnp.diagonal(k(Xs, Xs))
            var = jnp.clip(kss - jnp.sum(V * V, axis=0), 1e-10, None)
            return mean, var

        return GPCPosterior(tau, nu, mu, predict, deltas[-1])
