"""Exact Gaussian-process regression — the matmul-bound model family.

Beyond the reference's scope (its models are factor graphs of parametric
conjugate nodes) but a staple of the Bayesian toolbox this framework serves;
included because the exact-GP linear algebra (n×n kernel Cholesky, batched
triangular solves) maps straight onto matmul units, and the log marginal
likelihood is differentiable end-to-end so hyperparameters fit by the same
Adam/``lax.scan`` loop as everything else (`models/fit.py` style).

Design: kernels are plain functions on ``(..., d)`` points; the posterior is
computed in f64-free, jitter-stabilized f32 via Cholesky (never a matrix
inverse); predictions batch over any number of test points at once.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "GP",
    "GPPosterior",
    "fit_gp_ml",
    "rbf_kernel",
    "matern32_kernel",
    "matern52_kernel",
]


def _sqdist(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pairwise squared distances between ``(n, d)`` and ``(m, d)``."""
    return jnp.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)


def rbf_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Squared-exponential kernel k(x,x') = σ² exp(−|x−x'|²/2ℓ²)."""
    return variance * jnp.exp(-0.5 * _sqdist(a, b) / lengthscale**2)


def matern32_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Matérn-3/2: σ² (1+√3r/ℓ) exp(−√3r/ℓ) — once-differentiable paths."""
    r = jnp.sqrt(_sqdist(a, b) + 1e-12)
    z = jnp.sqrt(3.0) * r / lengthscale
    return variance * (1.0 + z) * jnp.exp(-z)


def matern52_kernel(a, b, lengthscale=1.0, variance=1.0):
    """Matérn-5/2: σ² (1+√5r/ℓ+5r²/3ℓ²) exp(−√5r/ℓ)."""
    r = jnp.sqrt(_sqdist(a, b) + 1e-12)
    z = jnp.sqrt(5.0) * r / lengthscale
    return variance * (1.0 + z + z**2 / 3.0) * jnp.exp(-z)


_KERNELS = {"rbf": rbf_kernel, "matern32": matern32_kernel, "matern52": matern52_kernel}


class GPPosterior(NamedTuple):
    """Fitted posterior: call ``predict(Xs)`` for test beliefs; ``lml`` is
    the log marginal likelihood of the training data."""

    mean_fn: Callable
    lml: jax.Array

    def predict(self, Xs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Posterior mean and variance at ``(m, d)`` test points."""
        return self.mean_fn(Xs)


@dataclasses.dataclass(frozen=True)
class GP:
    """Zero-mean GP prior ``f ~ GP(0, k)`` with Gaussian observation noise.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``) or a callable
    ``k(a, b, lengthscale, variance)``.
    """

    kernel: str | Callable = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def _k(self):
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def fit(self, X: jax.Array, y: jax.Array, jitter: float = 1e-6) -> GPPosterior:
        """Condition on ``(n, d)`` inputs and ``(n,)`` targets: one Cholesky
        of the n×n kernel matrix; prediction is two triangular solves."""
        X = jnp.atleast_2d(jnp.asarray(X))
        y = jnp.asarray(y)
        n = X.shape[0]
        k = self._k()
        K = k(X, X) + (self.noise + jitter) * jnp.eye(n, dtype=X.dtype)
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), y)
        lml = (
            -0.5 * y @ alpha
            - jnp.sum(jnp.log(jnp.diagonal(L)))
            - 0.5 * n * jnp.log(2.0 * jnp.pi)
        )

        def predict(Xs):
            Xs = jnp.atleast_2d(jnp.asarray(Xs))
            Ks = k(X, Xs)  # (n, m)
            mean = Ks.T @ alpha
            v = jax.scipy.linalg.solve_triangular(L, Ks, lower=True)  # (n, m)
            var = jnp.clip(
                jnp.diagonal(k(Xs, Xs)) - jnp.sum(v * v, axis=0), 1e-12, None
            )
            return mean, var

        return GPPosterior(predict, lml)

    def log_marginal_likelihood(self, X, y, jitter: float = 1e-6) -> jax.Array:
        """Differentiable w.r.t. the hyperparameters (close over them as
        traced values for gradient-based fitting or HMC)."""
        return self.fit(X, y, jitter=jitter).lml


def fit_gp_ml(
    X: jax.Array,
    y: jax.Array,
    kernel: str = "rbf",
    n_steps: int = 200,
    learning_rate: float = 0.05,
) -> Tuple[GP, jax.Array]:
    """ML-II hyperparameters (lengthscale, variance, noise) by Adam on the
    exact log marginal likelihood; returns the fitted :class:`GP` and the
    loss trace."""
    import optax

    X = jnp.atleast_2d(jnp.asarray(X))
    y = jnp.asarray(y)

    def nll(params):
        gp = GP(
            kernel=kernel,
            lengthscale=jnp.exp(params[0]),
            variance=jnp.exp(params[1]),
            noise=jnp.exp(params[2]),
        )
        return -gp.log_marginal_likelihood(X, y)

    opt = optax.adam(learning_rate)
    loss_grad = jax.value_and_grad(nll)

    def step(carry, _):
        p, s = carry
        loss, g = loss_grad(p)
        updates, s = opt.update(g, s)
        return (optax.apply_updates(p, updates), s), loss

    init = jnp.asarray([0.0, jnp.log(jnp.var(y) + 1e-4), jnp.log(jnp.var(y) / 10 + 1e-4)])
    (p, _), losses = jax.lax.scan(step, (init, opt.init(init)), None, length=n_steps)
    gp = GP(
        kernel=kernel,
        lengthscale=float(jnp.exp(p[0])),
        variance=float(jnp.exp(p[1])),
        noise=float(jnp.exp(p[2])),
    )
    return gp, losses
