"""Fused Pallas kernel for streaming HGF filtering (Triton route).

The HGF update (models/hgf.py::HGF.step, Mathys et al. 2011) is purely
elementwise per replica, so ``lax.scan`` over T launches T small kernels,
each touching ``(R,)`` rows in device memory.  This kernel runs the whole
trajectory of a block of replicas in one program: the four-number state
stays in registers for all T steps, and the program writes the final state
plus only the REQUESTED trajectory tracks — traffic is the input read plus
the tracks the caller will consume (filtering-only callers pay for the
input alone).

Same guard semantics as the model (clipped log-volatility, floored level-2
precision, capped level-2 step).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ._triton import replica_tile, resolve_interpret

__all__ = ["ALL_TRACKS", "hgf_filter_pallas"]

ALL_TRACKS = ("mu1", "pi1", "mu2", "pi2", "delta1")


def _hgf_kernel(u_ref, *refs, tracks, time_major, kappa, omega, theta, pi_u,
                max_log_nu, min_pi2, max_mu2_step):
    """One block of replicas.  ``u_ref`` and the track outputs are
    ``(tile, T)`` (``(T, tile)`` when ``time_major``); ``refs`` = the four
    ``(tile,)`` final-state outputs (mu1, pi1, mu2, pi2), then one output
    per requested track."""
    fin_refs, track_refs = refs[:4], refs[4:]
    T = u_ref.shape[0 if time_major else 1]

    def get(t):
        return u_ref[t, :] if time_major else u_ref[:, t]

    def put(ref, t, v):
        v = v.astype(ref.dtype)
        if time_major:
            ref[t, :] = v
        else:
            ref[:, t] = v

    def step(t, carry):
        mu1, pi1, mu2, pi2 = carry
        u = get(t)
        log_nu = jnp.clip(kappa * mu2 + omega, -max_log_nu, max_log_nu)
        nu = jnp.exp(log_nu)
        pihat1 = 1.0 / (1.0 / pi1 + nu)
        pi1_new = pihat1 + pi_u
        mu1_new = mu1 + (pi_u / pi1_new) * (u - mu1)
        d = mu1_new - mu1
        delta1 = (1.0 / pi1_new + d * d) * pihat1 - 1.0
        pihat2 = 1.0 / (1.0 / pi2 + theta)
        w1 = nu * pihat1
        pi2_new = pihat2 + 0.5 * kappa * kappa * w1 * (
            w1 + (2.0 * w1 - 1.0) * delta1
        )
        pi2_new = jnp.maximum(pi2_new, min_pi2)
        mu2_step = jnp.clip(
            0.5 * kappa * (w1 / pi2_new) * delta1, -max_mu2_step, max_mu2_step
        )
        mu2_new = mu2 + mu2_step
        values = {"mu1": mu1_new, "pi1": pi1_new, "mu2": mu2_new,
                  "pi2": pi2_new, "delta1": delta1}
        for name, ref in zip(tracks, track_refs):
            put(ref, t, values[name])
        return mu1_new, pi1_new, mu2_new, pi2_new

    zeros = jnp.zeros_like(get(0))
    final = lax.fori_loop(0, T, step, (zeros, zeros + 1.0, zeros, zeros + 1.0))
    for ref, v in zip(fin_refs, final):
        ref[...] = v


@functools.partial(jax.jit, static_argnums=tuple(range(1, 12)))
def _hgf_filter(u, tracks, track_dtype, kappa, omega, theta, pi_u, max_log_nu,
                min_pi2, max_mu2_step, tile, interpret):
    n, T = u.shape
    # Strided column loads of the natural (R, T) layout are cheap (a sector
    # serves 8 steps from cache) but strided stores are not: with tracks the
    # kernel runs time-major behind XLA transposes (6x faster on an H100 at
    # 65536 x 256 with 5 tracks), without tracks it reads u in place (1.4x).
    time_major = bool(tracks)
    pad = (-n) % tile
    if pad:
        u = jnp.concatenate([u, jnp.zeros((pad, T), u.dtype)], axis=0)
    n_padded = u.shape[0]
    if time_major:
        u = u.T
        seq = pl.BlockSpec((T, tile), lambda i: (0, i))
    else:
        seq = pl.BlockSpec((tile, T), lambda i: (i, 0))
    fin = pl.BlockSpec((tile,), lambda i: (i,))
    kernel = functools.partial(
        _hgf_kernel, tracks=tracks, time_major=time_major, kappa=kappa,
        omega=omega, theta=theta, pi_u=pi_u, max_log_nu=max_log_nu,
        min_pi2=min_pi2, max_mu2_step=max_mu2_step,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(n_padded // tile,),
        in_specs=[seq],
        out_specs=[fin] * 4 + [seq] * len(tracks),
        out_shape=[jax.ShapeDtypeStruct((n_padded,), u.dtype)] * 4
        + [jax.ShapeDtypeStruct(u.shape, track_dtype)] * len(tracks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(4, tile // 32))
        ),
        interpret=interpret,
        name="hgf_filter",
    )(u)
    finals = tuple(o[:n] for o in outs[:4])
    track_values = tuple((o.T if time_major else o)[:n] for o in outs[4:])
    return finals, track_values


def hgf_filter_pallas(
    u: jax.Array,
    kappa: float = 1.0,
    omega: float = -2.0,
    theta: float = 0.05,
    pi_u: float = 10.0,
    max_log_nu: float = 20.0,
    min_pi2: float = 1e-2,
    max_mu2_step: float = 5.0,
    tile: int | None = None,
    interpret: bool = False,
    tracks: tuple = ALL_TRACKS,
    track_dtype=None,
):
    """Filter ``u`` of shape ``(R, T)`` (zero-initialized state).

    Returns ``(finals, track_values)`` where ``finals`` is the final
    ``(mu1, pi1, mu2, pi2)`` state (each ``(R,)``) and ``track_values``
    holds one ``(R, T)`` array per name in ``tracks`` (a subset of
    :data:`ALL_TRACKS`, order preserved).  Filtering-only callers should
    pass ``tracks=()`` — output traffic scales with ``len(tracks)``.
    ``track_dtype`` (e.g. ``jnp.bfloat16``) casts the trajectory writes
    only; the recursion always runs in the input dtype.

    All scalar parameters must be concrete Python numbers — the kernel
    specializes on them.  For traced parameters (e.g. inside a
    gradient-based fit) use ``method='scan'``.  Runs compiled on a GPU;
    elsewhere pass ``interpret=True``.
    """
    params = dict(kappa=kappa, omega=omega, theta=theta, pi_u=pi_u,
                  max_log_nu=max_log_nu, min_pi2=min_pi2,
                  max_mu2_step=max_mu2_step)
    for name, val in params.items():
        if isinstance(val, jax.core.Tracer):
            raise ValueError(
                f"hgf_filter_pallas parameter {name!r} is a traced value; "
                "the Pallas kernel specializes on concrete parameters — "
                "use method='scan' for traced-parameter workflows"
            )
    unknown = set(tracks) - set(ALL_TRACKS)
    if unknown:
        raise ValueError(f"unknown tracks {sorted(unknown)}; valid: {ALL_TRACKS}")
    interpret = resolve_interpret(interpret, "hgf_filter_pallas")
    track_dtype = u.dtype if track_dtype is None else jnp.dtype(track_dtype)
    if tile is None:
        tile = replica_tile(u.shape[0], lo=32, hi=128)
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    return _hgf_filter(u, tuple(tracks), track_dtype, *params.values(), tile,
                       interpret)
