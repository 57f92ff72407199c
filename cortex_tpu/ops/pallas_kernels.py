"""Fused scalar-LGSSM smoothing sweep as one Pallas kernel (Triton route).

:func:`lgssm_smooth_pallas` runs the whole BP sweep — forward messages,
backward messages and marginals — inside one program per block of replicas,
with the time loop inside the program.  ``lax.scan`` on a GPU launches at
least one kernel per step, two sweeps of T steps each; this kernel is one
launch that reads ``y`` twice and writes the means.  It works on a
time-major copy of ``y`` (an XLA transpose on each side), so that every
step reads and writes one contiguous row of the block.

With fixed ``(A, Q, H, R)`` and dense data every precision in the sweep —
forward, backward and marginal — is the same for all replicas and does not
depend on ``y`` (``chains.py``'s operator note), so they are computed once,
in float64 on the host, as per-step coefficients.  The kernel carries only
the information means; the forward messages live in the mean output, which
the backward pass overwrites in place.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ._triton import replica_tile, resolve_interpret
from .chains import ChainMarginals

__all__ = ["lgssm_smooth_pallas", "smoother_coefficients"]


def smoother_coefficients(T: int, A: float, Q: float, H: float, R: float):
    """Per-step coefficients of the dense scalar sweep, float64 ``(T,)``.

    ``cf[t]`` maps the filtered information mean of x_{t-1} to the forward
    message into x_t, ``cb[t]`` maps the right belief of x_{t+1} to the
    backward message into x_t, and ``var[t]`` is the marginal variance.
    The same division-safe projections as :func:`chains._info_form_smooth`.
    """
    w_obs = H * H / R
    cf = np.zeros(T)
    w_f = np.zeros(T)
    w_c = w_obs
    for t in range(1, T):
        denom = A * A + Q * w_c
        cf[t] = A / denom
        w_f[t] = w_c / denom
        w_c = w_f[t] + w_obs
    cb = np.zeros(T)
    w_b = np.zeros(T)
    w_c = w_obs
    for t in range(T - 2, -1, -1):
        denom = 1.0 + Q * w_c
        cb[t] = A / denom
        w_b[t] = A * A * w_c / denom
        w_c = w_b[t] + w_obs
    return cf, cb, 1.0 / (w_obs + w_f + w_b)


def _smooth_kernel(y_ref, cf_ref, cb_ref, var_ref, mean_ref, *, h_r):
    """One block of replicas, time-major: ``y_ref``/``mean_ref`` are
    ``(T, tile)`` so each step reads and writes one contiguous row; the
    coefficients are ``(T,)``."""
    T = y_ref.shape[0]
    xi0 = h_r * y_ref[0, :]
    mean_ref[0, :] = jnp.zeros_like(xi0)  # no forward message into x_0

    def fwd(t, xi_c):  # xi_c: filtered information mean of x_{t-1}
        xi_msg = cf_ref[t] * xi_c
        mean_ref[t, :] = xi_msg
        return xi_msg + h_r * y_ref[t, :]

    xi_last = lax.fori_loop(1, T, fwd, xi0)
    mean_ref[T - 1, :] = xi_last * var_ref[T - 1]

    def bwd(i, xi_b):  # xi_b: right belief of x_{t+1}
        t = T - 2 - i
        xi_o = h_r * y_ref[t, :]
        xi_msg = cb_ref[t] * xi_b
        mean_ref[t, :] = (xi_o + mean_ref[t, :] + xi_msg) * var_ref[t]
        return xi_o + xi_msg

    lax.fori_loop(0, T - 1, bwd, h_r * y_ref[T - 1, :])


def lgssm_smooth_pallas(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    tile: int | None = None,
    interpret: bool = False,
) -> ChainMarginals:
    """Fused BP smoothing sweep; ``y``: ``(n_replicas, T)``, dense.

    Identical marginals to :func:`~cortex_tpu.ops.chains.lgssm_smooth_scan`
    (no-prior convention).  ``tile`` (a power of two) is the number of
    replicas per program; by default it is sized so the grid fills the card.
    Runs compiled on a GPU; elsewhere pass ``interpret=True``.
    """
    interpret = resolve_interpret(interpret, "lgssm_smooth_pallas")
    if tile is None:
        tile = replica_tile(y.shape[0], lo=32, hi=128)
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    return _smooth(y, A, Q, H, R, tile, interpret)


@functools.partial(jax.jit, static_argnums=tuple(range(1, 7)))
def _smooth(y, A, Q, H, R, tile, interpret):
    n, T = y.shape
    pad = (-n) % tile
    if pad:
        y = jnp.concatenate([y, jnp.zeros((pad, T), y.dtype)], axis=0)
    n_padded = y.shape[0]
    cf, cb, var = (
        jnp.asarray(c, y.dtype) for c in smoother_coefficients(T, A, Q, H, R)
    )

    # Time-major: strided column stores of the natural (R, T) layout cost
    # more than the two XLA transposes (2.3x at 100k x 1000 on an H100).
    block = pl.BlockSpec((T, tile), lambda i: (0, i))
    coef = pl.BlockSpec((T,), lambda i: (0,))
    mean = pl.pallas_call(
        functools.partial(_smooth_kernel, h_r=H / R),
        grid=(n_padded // tile,),
        in_specs=[block, coef, coef, coef],
        out_specs=block,
        out_shape=jax.ShapeDtypeStruct((T, n_padded), y.dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(4, tile // 32))
        ),
        interpret=interpret,
        name="lgssm_smooth",
    )(y.T, cf, cb, var)
    mean = mean.T[:n]
    return ChainMarginals(mean, jnp.broadcast_to(var, mean.shape))
