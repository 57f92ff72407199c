"""Gaussian message algebra in natural (information) form, batched over leading axes.

The reference's test algebra multiplies Gaussians by adding information-form
parameters (``/root/reference/test/runtests.jl:40-46,78-84``).  Here that
algebra is the *primitive*: a Gaussian message is ``(xi, w)`` with
``xi = w * mean`` (precision-weighted mean) and ``w`` the precision, stored as
arrays with arbitrary leading batch dimensions.  Products of messages are then
plain array additions — the operation XLA fuses and the Pallas segment kernels
reduce over — and moments are recovered at the end.

All functions are pure, jittable and vmappable; dtype follows the inputs
(float32 by default, float64 under ``jax.config.update("jax_enable_x64", True)``
for parity tests).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "Gaussian",
    "MvGaussian",
    "from_mean_variance",
    "from_mean_precision",
    "mv_from_mean_precision",
    "mv_from_mean_cov",
]

_LOG_2PI = math.log(2.0 * math.pi)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Gaussian:
    """Univariate Gaussian in information form: ``xi = w·μ``, ``w = 1/σ²``.

    Leading dimensions of ``xi``/``w`` are batch dimensions.
    """

    xi: jax.Array
    w: jax.Array

    # -- moments -------------------------------------------------------------
    @property
    def mean(self) -> jax.Array:
        return self.xi / self.w

    @property
    def variance(self) -> jax.Array:
        return 1.0 / self.w

    @property
    def precision(self) -> jax.Array:
        return self.w

    # -- algebra -------------------------------------------------------------
    def __mul__(self, other: "Gaussian") -> "Gaussian":
        """Product of densities (unnormalized): add natural parameters.

        Mirrors the reference's information-form product
        (``test/runtests.jl:40-46,78-84``).
        """
        return Gaussian(self.xi + other.xi, self.w + other.w)

    @classmethod
    def reduce_product(cls, stacked: "Gaussian", axis: int = 0) -> "Gaussian":
        """Product of k stacked Gaussians in ONE reduction — natural
        parameters are additive, so the fold is a plain sum.  Used by
        :func:`cortex_tpu.compile.product_reduce` to turn a high-arity
        marginal product (e.g. the mean-field noise posteriors' 99-message
        products) into one reduce instead of a k-deep add chain."""
        return cls(jnp.sum(stacked.xi, axis), jnp.sum(stacked.w, axis))

    def __truediv__(self, other: "Gaussian") -> "Gaussian":
        """Density quotient: subtract natural parameters (used for cavity /
        exclusion products: marginal ÷ one message)."""
        return Gaussian(self.xi - other.xi, self.w - other.w)

    def log_normalizer(self) -> jax.Array:
        """log ∫ exp(xi·x − w·x²/2) dx = xi²/(2w) + ½·log(2π/w)."""
        return 0.5 * (self.xi**2 / self.w + jnp.log(2.0 * jnp.pi / self.w))

    def logpdf(self, x: jax.Array) -> jax.Array:
        return -0.5 * (self.w * (x - self.mean) ** 2 + _LOG_2PI - jnp.log(self.w))

    def entropy(self) -> jax.Array:
        return 0.5 * (1.0 + _LOG_2PI - jnp.log(self.w))

    def kl(self, other: "Gaussian") -> jax.Array:
        """KL(self ‖ other)."""
        m, v = self.mean, self.variance
        mo, vo = other.mean, other.variance
        return 0.5 * (jnp.log(vo / v) + (v + (m - mo) ** 2) / vo - 1.0)

    def sample(self, key: jax.Array, shape: Tuple[int, ...] = ()) -> jax.Array:
        eps = jax.random.normal(key, shape + jnp.shape(self.xi), dtype=self.xi.dtype)
        return self.mean + eps * jnp.sqrt(self.variance)


def from_mean_variance(mean, variance) -> Gaussian:
    """Construct from (μ, σ²) — the reference's ``NormalMeanVariance``."""
    mean = jnp.asarray(mean)
    variance = jnp.asarray(variance)
    w = 1.0 / variance
    return Gaussian(mean * w, w)


def from_mean_precision(mean, precision) -> Gaussian:
    """Construct from (μ, w) — the reference's ``NormalMeanPrecision``."""
    mean = jnp.asarray(mean)
    precision = jnp.asarray(precision)
    return Gaussian(mean * precision, precision)



def _spd_solve_logdet(M, B):
    """Batched ``solve(M, B)`` + ``log det M`` for small SPD ``M`` via
    pivotless Gauss-Jordan — replacing the LU/getrf custom calls that
    ``jnp.linalg.solve``/``inv``/``slogdet`` lower to: a batched tiny-matrix
    custom call per step of the compiled structured-VMP sweep, which the
    closed elimination removes.  Pivotless elimination is PROVABLY valid
    here: an SPD matrix has strictly positive leading principal minors, so
    every pivot is nonzero.  Falls back to LAPACK lowering above d = 32
    (same threshold as ops/chains_mv)."""
    d = M.shape[-1]
    if d > 32:
        sol = jnp.linalg.solve(M, B)
        _, logdet = jnp.linalg.slogdet(M)
        return sol, logdet
    aug = jnp.concatenate([M, B], axis=-1)
    idx = jnp.arange(d)
    logdet = jnp.zeros(M.shape[:-2], M.dtype)
    for i in range(d):
        piv = aug[..., i, i]
        logdet = logdet + jnp.log(jnp.abs(piv))
        piv_row = aug[..., i : i + 1, :] / piv[..., None, None]
        factors = aug[..., :, i : i + 1]
        is_i = (idx == i)[:, None]
        aug = jnp.where(is_i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:], logdet


def _spd_inv(M):
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    return _spd_solve_logdet(M, eye)[0]


def _spd_logdet(M):
    return _spd_solve_logdet(M, M[..., :, :1])[1]


def _spd_cholesky(M):
    """Lower Cholesky of small SPD matrices as an unrolled batched
    elimination — no potrf custom call (the UKF sigma-point factor ran a
    batched Cholesky per scan step; see _spd_solve_logdet).  Falls back to
    the LAPACK lowering above d = 32."""
    d = M.shape[-1]
    if d > 32:
        return jnp.linalg.cholesky(M)
    L = jnp.zeros_like(M)
    for j in range(d):
        r = M[..., j:, j] - jnp.einsum(
            "...ik,...k->...i", L[..., j:, :j], L[..., j, :j]
        )
        diag = jnp.sqrt(r[..., 0])
        L = L.at[..., j:, j].set(r / diag[..., None])
    return L


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MvGaussian:
    """Multivariate Gaussian in information form: ``xi = W·μ``, ``W`` the
    precision matrix.  ``xi``: ``(..., d)``, ``W``: ``(..., d, d)``.

    The reference's ``MvNormalMeanPrecision`` analogue
    (``test/runtests.jl:69-76``).
    """

    xi: jax.Array
    W: jax.Array

    @property
    def dim(self) -> int:
        return self.xi.shape[-1]

    @property
    def mean(self) -> jax.Array:
        return _spd_solve_logdet(self.W, self.xi[..., None])[0][..., 0]

    @property
    def cov(self) -> jax.Array:
        return _spd_inv(self.W)

    @property
    def precision(self) -> jax.Array:
        return self.W

    def __mul__(self, other: "MvGaussian") -> "MvGaussian":
        return MvGaussian(self.xi + other.xi, self.W + other.W)

    @classmethod
    def reduce_product(cls, stacked: "MvGaussian", axis: int = 0) -> "MvGaussian":
        """Product of k stacked MvGaussians in ONE reduction (natural
        parameters additive)."""
        return cls(jnp.sum(stacked.xi, axis), jnp.sum(stacked.W, axis))

    def __truediv__(self, other: "MvGaussian") -> "MvGaussian":
        return MvGaussian(self.xi - other.xi, self.W - other.W)

    def log_normalizer(self) -> jax.Array:
        d = self.dim
        sol, logdet = _spd_solve_logdet(self.W, self.xi[..., None])
        return 0.5 * (
            jnp.einsum("...i,...i->...", self.xi, sol[..., 0])
            + d * _LOG_2PI
            - logdet
        )

    def entropy(self) -> jax.Array:
        d = self.dim
        eye = jnp.broadcast_to(jnp.eye(d, dtype=self.W.dtype), self.W.shape)
        _, logdet = _spd_solve_logdet(self.W, eye[..., :1])
        return 0.5 * (d * (1.0 + _LOG_2PI) - logdet)

    def logpdf(self, x: jax.Array) -> jax.Array:
        d = self.dim
        sol, logdet = _spd_solve_logdet(self.W, self.xi[..., None])
        diff = x - sol[..., 0]
        quad = jnp.einsum("...i,...ij,...j->...", diff, self.W, diff)
        return -0.5 * (quad + d * _LOG_2PI - logdet)

    def sample(self, key: jax.Array, shape: Tuple[int, ...] = ()) -> jax.Array:
        chol = jnp.linalg.cholesky(self.cov)
        eps = jax.random.normal(key, shape + self.xi.shape, dtype=self.xi.dtype)
        return self.mean + jnp.einsum("...ij,...j->...i", chol, eps)


def mv_from_mean_precision(mean, precision) -> MvGaussian:
    """Construct from (mean ``(..., d)``, precision ``(..., d, d)``)."""
    mean = jnp.asarray(mean)
    precision = jnp.asarray(precision)
    xi = jnp.einsum("...ij,...j->...i", precision, mean)
    return MvGaussian(xi, precision)


def mv_from_mean_cov(mean, cov) -> MvGaussian:
    """Construct from (mean ``(..., d)``, covariance ``(..., d, d)``)."""
    mean = jnp.asarray(mean)
    W = _spd_inv(jnp.asarray(cov))
    return mv_from_mean_precision(mean, W)
