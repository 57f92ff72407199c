"""Sparse variational GP regression (Titsias SGPR) — the large-n GP path.

Extends the exact-GP family (`cortex_tpu/models/gp.py`) past the O(n³)
Cholesky wall with m ≪ n inducing points: the collapsed variational bound
(Titsias 2009) costs O(n m²) — all batched matmuls and m×m triangular
factors, exactly the shapes matmul units want — and is a *lower bound* on the
exact log marginal likelihood, recovering it when the inducing set equals
the training inputs.  Inducing locations are ordinary differentiable
parameters, so they fit by the same Adam/`lax.scan` loop as every other
hyperparameter in the framework (`models/fit.py` stance).

Beyond the reference's scope (its models are parametric conjugate factor
graphs, `/root/reference/src/model_engine.jl:30-230`); included because a
production Bayesian toolbox needs nonparametric regression that scales.

Formulas follow the standard numerically-stable SGPR parameterization
(one m×m Cholesky of ``B = I + A Aᵀ`` with ``A = L⁻¹ K_mn / σ``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .gp import _KERNELS

__all__ = ["SGPR", "SGPRPosterior", "fit_sgpr_ml"]


class SGPRPosterior(NamedTuple):
    """Fitted sparse posterior: ``elbo`` is the collapsed variational lower
    bound on the exact log marginal likelihood; ``predict(Xs)`` returns
    posterior mean and variance at test points."""

    mean_fn: Callable
    elbo: jax.Array

    def predict(self, Xs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        return self.mean_fn(Xs)


@dataclasses.dataclass(frozen=True)
class SGPR:
    """Sparse GP regression with Gaussian noise and m inducing points.

    ``kernel``: name (``"rbf"``/``"matern32"``/``"matern52"``) or a callable
    ``k(a, b, lengthscale, variance)`` (same contract as :class:`GP`).
    """

    kernel: str | Callable = "rbf"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def _k(self):
        k = _KERNELS[self.kernel] if isinstance(self.kernel, str) else self.kernel
        return partial(k, lengthscale=self.lengthscale, variance=self.variance)

    def fit(
        self, X: jax.Array, y: jax.Array, Z: jax.Array, jitter: float = 1e-6
    ) -> SGPRPosterior:
        """Condition on ``(n, d)`` inputs / ``(n,)`` targets with ``(m, d)``
        inducing locations ``Z``.  O(n m²) work, one m×m Cholesky pair."""
        X = jnp.atleast_2d(jnp.asarray(X))
        Z = jnp.atleast_2d(jnp.asarray(Z))
        y = jnp.asarray(y)
        n, m = X.shape[0], Z.shape[0]
        k = self._k()
        sigma = jnp.sqrt(self.noise)

        # Jitter scales with the kernel variance: in f32 the Cholesky of a
        # wide-lengthscale Kmm is rank-deficient at any fixed absolute jitter.
        Kmm = k(Z, Z) + jitter * (1.0 + self.variance) * jnp.eye(m, dtype=X.dtype)
        Kmn = k(Z, X)  # (m, n)
        L = jnp.linalg.cholesky(Kmm)
        A = jax.scipy.linalg.solve_triangular(L, Kmn, lower=True) / sigma  # (m, n)
        B = jnp.eye(m, dtype=X.dtype) + A @ A.T
        LB = jnp.linalg.cholesky(B)
        Ay = A @ y / sigma  # (m,)
        c = jax.scipy.linalg.solve_triangular(LB, Ay, lower=True)

        if isinstance(self.kernel, str):
            knn_diag = jnp.full((n,), self.variance, X.dtype)
        else:
            knn_diag = jnp.diagonal(k(X, X))
        trace_term = jnp.sum(knn_diag) / self.noise - jnp.sum(A * A)

        elbo = (
            -0.5 * n * jnp.log(2.0 * jnp.pi * self.noise)
            - jnp.sum(jnp.log(jnp.diagonal(LB)))
            - 0.5 * (y @ y) / self.noise
            + 0.5 * (c @ c)
            - 0.5 * trace_term
        )

        def predict(Xs):
            Xs = jnp.atleast_2d(jnp.asarray(Xs))
            Kms = k(Z, Xs)  # (m, s)
            t1 = jax.scipy.linalg.solve_triangular(L, Kms, lower=True)
            t2 = jax.scipy.linalg.solve_triangular(LB, t1, lower=True)
            mean = t2.T @ c
            kss = (
                jnp.full((Xs.shape[0],), self.variance, X.dtype)
                if isinstance(self.kernel, str)
                else jnp.diagonal(k(Xs, Xs))
            )
            var = jnp.clip(
                kss - jnp.sum(t1 * t1, axis=0) + jnp.sum(t2 * t2, axis=0),
                1e-12,
                None,
            )
            return mean, var

        return SGPRPosterior(predict, elbo)

    def elbo(self, X, y, Z, jitter: float = 1e-6) -> jax.Array:
        """Collapsed bound, differentiable w.r.t. hyperparameters *and* Z."""
        return self.fit(X, y, Z, jitter=jitter).elbo


def fit_sgpr_ml(
    X: jax.Array,
    y: jax.Array,
    n_inducing: int = 32,
    kernel: str = "rbf",
    n_steps: int = 300,
    learning_rate: float = 0.05,
    seed: int = 0,
) -> Tuple[SGPR, jax.Array, jax.Array]:
    """Fit hyperparameters *and* inducing locations by Adam on the collapsed
    ELBO.  Inducing points initialize to a random training subset.  Returns
    ``(fitted SGPR, fitted Z, loss trace)``."""
    import optax

    X = jnp.atleast_2d(jnp.asarray(X))
    y = jnp.asarray(y)
    idx = jax.random.permutation(jax.random.PRNGKey(seed), X.shape[0])[:n_inducing]
    Z0 = X[idx]

    def nll(params):
        log_hyp, Z = params
        m = SGPR(
            kernel=kernel,
            lengthscale=jnp.exp(log_hyp[0]),
            variance=jnp.exp(log_hyp[1]),
            # Noise floor: the collapsed bound's trace penalty is O(1/σ²) and
            # f32 optimization can otherwise drive σ² → 0 before Z catches up.
            noise=jnp.exp(log_hyp[2]) + 1e-4,
        )
        return -m.elbo(X, y, Z, jitter=1e-5)

    opt = optax.adam(learning_rate)
    loss_grad = jax.value_and_grad(nll)

    def step(carry, _):
        p, s = carry
        loss, g = loss_grad(p)
        updates, s = opt.update(g, s)
        return (optax.apply_updates(p, updates), s), loss

    init_hyp = jnp.asarray(
        [0.0, jnp.log(jnp.var(y) + 1e-4), jnp.log(jnp.var(y) / 10 + 1e-4)]
    )
    (params, _), losses = jax.lax.scan(
        step, ((init_hyp, Z0), opt.init((init_hyp, Z0))), None, length=n_steps
    )
    log_hyp, Z = params
    model = SGPR(
        kernel=kernel,
        lengthscale=float(jnp.exp(log_hyp[0])),
        variance=float(jnp.exp(log_hyp[1])),
        noise=float(jnp.exp(log_hyp[2])) + 1e-4,
    )
    return model, Z, losses
