"""Expectation propagation — parallel (batched-site) EP for linear models.

Completes the framework's algorithm families alongside BP, VMP, EM, particle
and projected-Gaussian (EKF/UKF) inference.  The reference's processor
interface admits EP rule sets (its `compute_message_to_*` hooks are
rule-agnostic, `/root/reference/src/inference_engine.jl:331-477`) but ships
none; here EP is first-class and batched:

- **Parallel EP**: every site's cavity/tilt/update is computed at once per
  iteration (one gather → moment-match → scatter), not site-by-site as in
  textbook sequential EP.  The per-iteration cost is one ``d×d`` solve plus
  vectorized scalar moment matching — matmuls + elementwise ops.
- **Moment matching** is either closed-form (probit) or Gauss–Hermite
  quadrature of a user-supplied scalar log-likelihood — the same
  "user supplies the rule algebra" stance as the reference.
- The whole optimization is a ``lax.scan`` under ``jit``; damping and cavity
  floors keep bf16/f32-friendly stability.

Model:  w ~ N(0, prior_var · I),  z_i = x_i·w,  y_i ~ p(y_i | z_i).
EP sites are Gaussian approximations t_i(z_i) = N(z_i; ν_i/τ_i, 1/τ_i).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.stats import norm

__all__ = [
    "EPResult",
    "ep_linear_model",
    "probit_tilted_moments",
    "gauss_hermite_tilted",
]


class EPResult(NamedTuple):
    """Posterior over the weights plus the converged site parameters.

    ``mean``: ``(d,)``; ``cov``: ``(d, d)``; ``site_tau``/``site_nu``:
    ``(n,)`` natural parameters of each likelihood approximation;
    ``site_delta``: max site-parameter change in the last iteration
    (convergence diagnostic).
    """

    mean: jax.Array
    cov: jax.Array
    site_tau: jax.Array
    site_nu: jax.Array
    site_delta: jax.Array


def probit_tilted_moments(y: jax.Array) -> Callable:
    """Closed-form tilted moments for probit sites ``p(y|z) = Φ(y z)``,
    ``y ∈ {-1, +1}`` (Rasmussen & Williams eq. 3.58): exact, no quadrature."""
    y = jnp.asarray(y)

    def moments(mu_cav, var_cav):
        s = jnp.sqrt(1.0 + var_cav)
        t = y * mu_cav / s
        # φ(t)/Φ(t), computed in log space for stability in the tails.
        ratio = jnp.exp(norm.logpdf(t) - norm.logcdf(t))
        mean = mu_cav + y * var_cav * ratio / s
        var = var_cav - var_cav**2 * ratio * (t + ratio) / (1.0 + var_cav)
        return mean, var

    return moments


def gauss_hermite_tilted(log_lik: Callable, n_points: int = 31) -> Callable:
    """Tilted moments by Gauss–Hermite quadrature of an arbitrary scalar
    ``log_lik(z)`` (vectorized over sites): the generic fallback when no
    closed form exists.  ``log_lik`` receives ``z`` shaped ``(n_sites,
    n_points)`` and returns elementwise log-likelihoods."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(n_points)  # weight e^{-x²/2}
    nodes = jnp.asarray(nodes, dtype=jnp.float32)
    logw = jnp.asarray(np.log(weights / np.sqrt(2.0 * np.pi)), dtype=jnp.float32)

    def moments(mu_cav, var_cav):
        sd = jnp.sqrt(var_cav)
        z = mu_cav[:, None] + sd[:, None] * nodes[None, :]  # (n, k)
        logp = logw[None, :] + log_lik(z)
        logZ = jax.nn.logsumexp(logp, axis=1, keepdims=True)
        w = jnp.exp(logp - logZ)
        mean = jnp.sum(w * z, axis=1)
        var = jnp.sum(w * (z - mean[:, None]) ** 2, axis=1)
        return mean, var

    return moments


def ep_linear_model(
    X: jax.Array,
    tilted_moments: Callable,
    prior_var: float = 1.0,
    n_iters: int = 30,
    damping: float = 0.8,
    tau_floor: float = 1e-8,
) -> EPResult:
    """Parallel EP posterior ``q(w) = N(mean, cov)`` for a Bayesian linear
    model with factorizing scalar likelihood sites.

    ``X``: ``(n, d)`` design matrix; ``tilted_moments(mu_cav, var_cav) ->
    (mean, var)`` moment-matches every site's tilted distribution at once
    (:func:`probit_tilted_moments` or :func:`gauss_hermite_tilted`).
    Conjugate (Gaussian) sites converge in one iteration to the exact
    posterior; non-conjugate sites typically need 10–30 damped iterations.
    """
    X = jnp.asarray(X)
    n, d = X.shape
    prior_prec = jnp.eye(d, dtype=X.dtype) / prior_var

    def posterior(tau, nu):
        Sinv = prior_prec + X.T @ (tau[:, None] * X)
        # One Cholesky factorization serves the mean and all site marginals.
        L = jnp.linalg.cholesky(Sinv)
        m = jax.scipy.linalg.cho_solve((L, True), X.T @ nu)
        V = jax.scipy.linalg.cho_solve((L, True), X.T)  # (d, n) = S Xᵀ
        sigma2 = jnp.sum(X * V.T, axis=1)  # diag(X S Xᵀ)
        return m, L, sigma2

    def step(state, _):
        tau, nu = state
        m, _, sigma2 = posterior(tau, nu)
        mu = X @ m
        # Cavity (floored: deleting a strong site from a tight marginal can
        # transiently produce a non-positive precision).
        tau_cav = jnp.maximum(1.0 / sigma2 - tau, tau_floor)
        nu_cav = mu / sigma2 - nu
        mu_cav = nu_cav / tau_cav
        var_cav = 1.0 / tau_cav
        mt, vt = tilted_moments(mu_cav, var_cav)
        vt = jnp.maximum(vt, 1e-10)
        tau_new = jnp.maximum(1.0 / vt - tau_cav, tau_floor)
        nu_new = mt / vt - nu_cav
        tau_next = (1.0 - damping) * tau + damping * tau_new
        nu_next = (1.0 - damping) * nu + damping * nu_new
        delta = jnp.maximum(
            jnp.max(jnp.abs(tau_next - tau)), jnp.max(jnp.abs(nu_next - nu))
        )
        return (tau_next, nu_next), delta

    init = (jnp.full((n,), tau_floor, X.dtype), jnp.zeros((n,), X.dtype))
    (tau, nu), deltas = lax.scan(step, init, None, length=n_iters)
    m, L, _ = posterior(tau, nu)
    cov = jax.scipy.linalg.cho_solve((L, True), jnp.eye(d, dtype=X.dtype))
    return EPResult(m, cov, tau, nu, deltas[-1])
