"""Square-root Kalman filtering/smoothing — QR-factored covariance propagation.

Low-precision robustness layer for the LGSSM family.  The standard covariance
recursions (`cortex_tpu.ops.chains_mv`) subtract nearly-equal matrices
(``P - K S Kᵀ``), which in f32/bf16 can lose positive-definiteness on
ill-conditioned chains (tiny observation noise, long horizons).  The
square-root ("array") algorithm instead propagates a triangular factor
``S`` with ``P = S Sᵀ`` through orthogonal transformations — every step is a
QR factorization of a stacked pre-array, so the covariance is PSD *by
construction* and the effective precision doubles (condition number of ``S``
is the square root of that of ``P``).

Mapping: each step is a batched thin QR of a ``(2d, d)`` / ``(m+d, m+d)``
pre-array — Householder reflections lower onto matmuls, batched over
replicas.  The sweep is a ``lax.scan`` (sequential in time: this is the
robust path; the fast path is the associative scan in ``chains_mv``).

The reference has no numerical-robustness machinery at all (its payloads are
opaque user objects, ``/root/reference/src/signal.jl:82-115``); this subsystem
exists because f32/bf16 is the accelerator's native regime.

References: Kailath, Sayed & Hassibi, *Linear Estimation*, ch. 12 (array
algorithms); Särkkä, *Bayesian Filtering and Smoothing*, §6.3.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils import float32_matmuls

from .chains_mv import MvChainMarginals

__all__ = ["SqrtFilterBeliefs", "sqrt_lgssm_filter", "sqrt_lgssm_smooth"]


def _mT(x: jax.Array) -> jax.Array:
    return jnp.swapaxes(x, -1, -2)


def _tria(stacked: jax.Array) -> jax.Array:
    """Lower-triangular factor of ``stackedᵀ @ stacked`` via thin QR.

    ``stacked``: ``(..., k, d)`` pre-array whose Gram matrix is the target
    covariance.  Returns ``(..., d, d)`` lower triangular ``S`` with
    ``S Sᵀ = stackedᵀ stacked``, sign-normalized to a non-negative diagonal
    (QR's R has arbitrary row signs).
    """
    r = jnp.linalg.qr(stacked, mode="r")  # (..., d, d) upper
    sign = jnp.sign(jnp.diagonal(r, axis1=-2, axis2=-1))
    sign = jnp.where(sign == 0, 1.0, sign)
    return _mT(r * sign[..., :, None])


class SqrtFilterBeliefs(NamedTuple):
    """Filtered beliefs in square-root form.

    ``mean``: ``(..., T, d)``; ``chol``: ``(..., T, d, d)`` lower-triangular
    factors of the filtered covariances (``P = chol @ cholᵀ``).
    """

    mean: jax.Array
    chol: jax.Array


def _prepare(y, A, Q, H, R, prior):
    y = jnp.asarray(y)
    A, Q, H, R = map(lambda a: jnp.asarray(a, y.dtype), (A, Q, H, R))
    m0 = jnp.asarray(prior[0], y.dtype)
    P0 = jnp.asarray(prior[1], y.dtype)
    Lq = jnp.linalg.cholesky(Q)
    Lr = jnp.linalg.cholesky(R)
    L0 = jnp.linalg.cholesky(P0)
    # Missing steps (any NaN in the observation vector) skip the measurement
    # update — same full-vector-missingness convention as `chains_mv`.
    observed = ~jnp.any(jnp.isnan(y), axis=-1)  # (..., T)
    y = jnp.where(observed[..., None], y, 0.0)
    obsT = jnp.moveaxis(observed, -1, 0)  # (T, ...)
    yT = jnp.moveaxis(y, -2, 0)  # (T, ..., m)
    return yT, obsT, A, H, Lq, Lr, m0, L0


@float32_matmuls
def sqrt_lgssm_filter(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> SqrtFilterBeliefs:
    """Square-root Kalman filter.

    Parameters mirror :func:`cortex_tpu.ops.chains_mv.mv_lgssm_smooth`:
    ``y`` is ``(..., T, m)``, ``A``/``Q`` are ``(d, d)``, ``H`` is ``(m, d)``,
    ``R`` is ``(m, m)``, ``prior = (m0, P0)``.  Never forms a full covariance:
    predict and update are each one QR of a stacked pre-array.
    """
    yT, obsT, A, H, Lq, Lr, m0, L0 = _prepare(y, A, Q, H, R, prior)
    batch = yT.shape[1:-1]
    d = A.shape[-1]
    m = H.shape[-2]

    def measurement(mean, S, obs, mask):
        # Pre-array Gram = [[S_y S_yᵀ, ...], [..., P_filt + K S_y ...]]:
        #   U = [[Lrᵀ, 0], [Sᵀ Hᵀ, Sᵀ]]  ⇒  UᵀU = [[R + H P Hᵀ, H P], [P Hᵀ, P]]
        top = jnp.concatenate(
            [jnp.broadcast_to(_mT(Lr), S.shape[:-2] + (m, m)),
             jnp.zeros(S.shape[:-2] + (m, d), S.dtype)],
            axis=-1,
        )
        bot = jnp.concatenate(
            [_mT(S) @ jnp.broadcast_to(_mT(H), S.shape[:-2] + (d, m)), _mT(S)], axis=-1
        )
        post = _tria(jnp.concatenate([top, bot], axis=-2))  # (..., m+d, m+d)
        Sy = post[..., :m, :m]  # chol of innovation cov
        Kbar = post[..., m:, :m]  # K @ Sy
        S_f = post[..., m:, m:]  # chol of filtered cov
        innov = obs - jnp.einsum("md,...d->...m", H, mean)
        # K (y − H m) = Kbar Sy⁻¹ innov
        u = jax.scipy.linalg.solve_triangular(Sy, innov[..., None], lower=True)
        mean_f = mean + (Kbar @ u)[..., 0]
        keep = jnp.broadcast_to(mask[..., None], mean.shape)
        keep2 = jnp.broadcast_to(mask[..., None, None], S_f.shape)
        return (
            jnp.where(keep, mean_f, mean),
            jnp.where(keep2, S_f, jnp.broadcast_to(S, S_f.shape)),
        )

    def predict(mean, S):
        stacked = jnp.concatenate(
            [_mT(S) @ jnp.broadcast_to(_mT(A), S.shape[:-2] + (d, d)),
             jnp.broadcast_to(_mT(Lq), S.shape[:-2] + (d, d))],
            axis=-2,
        )  # (..., 2d, d); Gram = A P Aᵀ + Q
        return jnp.einsum("ij,...j->...i", A, mean), _tria(stacked)

    mean1, S1 = measurement(
        jnp.broadcast_to(m0, batch + (d,)),
        jnp.broadcast_to(L0, batch + (d, d)),
        yT[0],
        obsT[0],
    )

    def step(carry, inp):
        obs, mask = inp
        mean, S = carry
        mp, Sp = predict(mean, S)
        mf, Sf = measurement(mp, Sp, obs, mask)
        return (mf, Sf), (mf, Sf)

    _, (means, chols) = lax.scan(step, (mean1, S1), (yT[1:], obsT[1:]))
    means = jnp.concatenate([mean1[None], means], axis=0)
    chols = jnp.concatenate([S1[None], chols], axis=0)
    return SqrtFilterBeliefs(jnp.moveaxis(means, 0, -2), jnp.moveaxis(chols, 0, -3))


@float32_matmuls
def sqrt_lgssm_smooth(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> MvChainMarginals:
    """Square-root RTS smoother: sqrt filter forward, sqrt-propagated
    backward pass.

    The smoothed covariance recursion ``P_s = P_f + G (P_s' − P_p) Gᵀ`` is
    computed in factored form via the Joseph-style identity
    ``P_f − G P_p Gᵀ = (I − G A) P_f (I − G A)ᵀ + G Q Gᵀ``, so the backward
    step is one QR of a ``(3d, d)`` pre-array — PSD by construction.  Returns
    full covariances (same contract as
    :func:`cortex_tpu.ops.chains_mv.mv_lgssm_smooth`).
    """
    beliefs = sqrt_lgssm_filter(y, A, Q, H, R, prior)
    yT, _, A, H, Lq, Lr, m0, L0 = _prepare(y, A, Q, H, R, prior)
    d = A.shape[-1]
    fm = jnp.moveaxis(beliefs.mean, -2, 0)  # (T, ..., d)
    fS = jnp.moveaxis(beliefs.chol, -3, 0)  # (T, ..., d, d)
    I = jnp.eye(d, dtype=yT.dtype)

    def back(carry, inp):
        ms, Ss = carry  # smoothed at t+1 (mean, chol)
        mf, Sf = inp  # filtered at t
        Pf = Sf @ _mT(Sf)
        # Predicted sqrt at t+1 from the filtered factor (one QR).
        Sp = _tria(
            jnp.concatenate(
                [
                    _mT(Sf) @ jnp.broadcast_to(_mT(A), Sf.shape),
                    jnp.broadcast_to(_mT(Lq), Sf.shape),
                ],
                axis=-2,
            )
        )
        # Gain G = P_f Aᵀ P_p⁻¹ via two triangular solves against Sp.
        t1 = jax.scipy.linalg.solve_triangular(Sp, A @ Pf, lower=True)
        G = _mT(jax.scipy.linalg.solve_triangular(_mT(Sp), t1, lower=False))
        mean_s = mf + jnp.einsum("...ij,...j->...i", G, ms - jnp.einsum("ij,...j->...i", A, mf))
        IGA = jnp.broadcast_to(I, G.shape) - G @ A
        stacked = jnp.concatenate(
            [_mT(Sf) @ _mT(IGA), jnp.broadcast_to(_mT(Lq), G.shape) @ _mT(G), _mT(Ss) @ _mT(G)],
            axis=-2,
        )  # (..., 3d, d)
        S_s = _tria(stacked)
        return (mean_s, S_s), (mean_s, S_s)

    init = (fm[-1], fS[-1])
    _, (means, chols) = lax.scan(back, init, (fm[:-1], fS[:-1]), reverse=True)
    means = jnp.concatenate([means, fm[-1:]], axis=0)
    chols = jnp.concatenate([chols, fS[-1:]], axis=0)
    covs = chols @ _mT(chols)
    return MvChainMarginals(jnp.moveaxis(means, 0, -2), jnp.moveaxis(covs, 0, -3))
