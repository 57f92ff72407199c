"""Fused scaled forward-backward for discrete HMM chains (Pallas, Triton).

The log-space scan (:mod:`cortex_tpu.ops.hmm`) is numerically bulletproof
but, on a GPU, launches kernels at every one of its 2T steps.  This kernel
runs the *scaled* forward-backward — per-step renormalized probabilities,
the classical Rabiner scaling — as one program per block of replicas with
both time loops inside the program:

- ``alpha_t ∝ (alpha_{t-1} A) * lik_t`` and
  ``beta_t ∝ A (lik_{t+1} * beta_{t+1})``, each a ``(tile, K, K)``
  broadcast-multiply-sum in registers (K is far below a tensor-core tile);
  K is padded to a power of two with states of zero mass;
- the per-step normalizers accumulate into ``log Z``;
- the forward pass stores its normalized alphas in the marginal output and
  the backward pass overwrites them with the marginals in place;
- the counts variant also sums the pairwise marginals
  ``xi_t ∝ alpha_t[j] A[j, k] lik_{t+1}[k] beta_{t+1}[k]`` in registers, so
  the whole Dirichlet-VMP E-step reads the likelihoods and writes the
  marginals once.

Equal to the log-space path up to float32 rounding of the scaled recursion.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ._triton import next_pow2, replica_tile, resolve_interpret

__all__ = [
    "hmm_forward_backward_pallas",
    "hmm_forward_backward_counts_pallas",
    "HMMPallasPosterior",
    "HMMPallasCounts",
]

_TINY = 1e-30


class HMMPallasPosterior(NamedTuple):
    gamma: jax.Array  # (R, T, K) state marginals
    log_evidence: jax.Array  # (R,)


class HMMPallasCounts(NamedTuple):
    gamma: jax.Array  # (R, T, K)
    xi_sum: jax.Array  # (R, K, K) summed pairwise marginals
    log_evidence: jax.Array  # (R,)


def _fb_kernel(lik_ref, a_ref, pi_ref, gamma_ref, logz_ref, *xi_ref):
    """One block of replicas in the natural layout.  ``lik_ref`` and
    ``gamma_ref``: ``(tile, T, K)``, so a step moves K contiguous values per
    replica; ``a_ref``: ``(K, K)``; ``pi_ref``: ``(K,)``; ``logz_ref``:
    ``(tile,)``; the optional ``xi_ref``: ``(tile, K, K)``."""
    T = lik_ref.shape[1]

    def normalizer(x):
        return jnp.maximum(jnp.sum(x, axis=1), _TINY)

    A = a_ref[...]
    if A.shape[0] >= 16:
        # Triton turns a broadcast-multiply-sum this wide into a dot that
        # defaults to TF32 (log-evidence off by 1e-3 at K=16): ask for an
        # IEEE float32 dot instead.
        def times_A(x):  # x @ A
            return jnp.dot(x, A, precision=lax.Precision.HIGHEST)

        def times_At(x):  # x @ A.T
            return lax.dot_general(x, A, (((1,), (1,)), ((), ())),
                                   precision=lax.Precision.HIGHEST)
    else:
        def times_A(x):
            return jnp.sum(x[:, :, None] * A[None, :, :], axis=1)

        def times_At(x):
            return jnp.sum(x[:, None, :] * A[None, :, :], axis=2)

    a0 = pi_ref[...][None, :] * lik_ref[:, 0, :]
    n0 = normalizer(a0)
    a0 = a0 / n0[:, None]
    gamma_ref[:, 0, :] = a0

    def fwd(t, carry):
        alpha, logz = carry
        a = times_A(alpha) * lik_ref[:, t, :]
        n = normalizer(a)
        a = a / n[:, None]
        gamma_ref[:, t, :] = a
        return a, logz + jnp.log(n)

    _, logz = lax.fori_loop(1, T, fwd, (a0, jnp.log(n0)))
    logz_ref[...] = logz

    def bwd(i, carry):
        beta, S = carry
        t = T - 2 - i
        w = lik_ref[:, t + 1, :] * beta
        b = times_At(w)
        alpha = gamma_ref[:, t, :]  # still alpha_t
        g = alpha * b
        N = normalizer(g)
        gamma_ref[:, t, :] = g / N[:, None]
        if xi_ref:
            S = S + (alpha / N[:, None])[:, :, None] * w[:, None, :]
        return b / normalizer(b)[:, None], S

    K = A.shape[0]
    S0 = jnp.zeros((a0.shape[0], K, K) if xi_ref else (), a0.dtype)
    _, S = lax.fori_loop(0, T - 1, bwd, (jnp.ones_like(a0), S0))
    if xi_ref:
        xi_ref[0][...] = A[None, :, :] * S


def _plan(R: int, K: int, tile: int | None) -> int:
    """Replica block: powers of two, with the ``(tile, K, K)`` register
    products held to 4096 elements."""
    Kp = next_pow2(K)
    if tile is None:
        tile = replica_tile(R, lo=16, hi=max(16, 4096 // (Kp * Kp)))
    if tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    return tile


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _forward_backward(lik, A, pi, counts, tile, interpret):
    R, T, K = lik.shape
    Kp = next_pow2(K)
    pad_r = (-R) % tile
    dt = lik.dtype
    # Padded replicas see uniform likelihoods; padded states have zero mass
    # (zero likelihood, zero prior, zero transitions in and out).
    lik = jnp.pad(lik, ((0, pad_r), (0, 0), (0, Kp - K)))
    if pad_r:
        lik = lik.at[R:, :, :K].set(1.0)
    A_ = jnp.pad(A.astype(dt), ((0, Kp - K), (0, Kp - K)))
    pi_ = jnp.pad(pi.astype(dt), (0, Kp - K))
    Rp = R + pad_r

    # The natural layout: on an H100 it matched a time-major copy at K=4
    # and K=16 without paying for the transposes.
    seq = pl.BlockSpec((tile, T, Kp), lambda i: (i, 0, 0))
    out_specs = [seq, pl.BlockSpec((tile,), lambda i: (i,))]
    out_shape = [jax.ShapeDtypeStruct(lik.shape, dt),
                 jax.ShapeDtypeStruct((Rp,), dt)]
    if counts:
        out_specs.append(pl.BlockSpec((tile, Kp, Kp), lambda i: (i, 0, 0)))
        out_shape.append(jax.ShapeDtypeStruct((Rp, Kp, Kp), dt))
    outs = pl.pallas_call(
        _fb_kernel,
        grid=(Rp // tile,),
        in_specs=[
            seq,
            pl.BlockSpec((Kp, Kp), lambda i: (0, 0)),
            pl.BlockSpec((Kp,), lambda i: (0,)),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(4, tile * Kp // 64))
        ),
        interpret=interpret,
        name="hmm_forward_backward",
    )(lik, A_, pi_)
    gamma, logz = outs[0][:R, :, :K], outs[1][:R]
    if counts:
        return HMMPallasCounts(gamma, outs[2][:R, :K, :K], logz)
    return HMMPallasPosterior(gamma, logz)


def hmm_forward_backward_pallas(
    lik: jax.Array,
    A: jax.Array,
    pi: jax.Array,
    tile: int | None = None,
    interpret: bool = False,
) -> HMMPallasPosterior:
    """Scaled forward-backward; ``lik``: ``(R, T, K)`` per-step likelihoods
    (linear space), ``A``: ``(K, K)`` row-stochastic, ``pi``: ``(K,)``.

    Runs compiled on a GPU; elsewhere pass ``interpret=True``.
    """
    interpret = resolve_interpret(interpret, "hmm_forward_backward_pallas")
    tile = _plan(lik.shape[0], lik.shape[2], tile)
    return _forward_backward(lik, A, pi, False, tile, interpret)


def hmm_forward_backward_counts_pallas(
    lik: jax.Array,
    A: jax.Array,
    pi: jax.Array,
    tile: int | None = None,
    interpret: bool = False,
) -> HMMPallasCounts:
    """Scaled forward-backward emitting state marginals AND summed pairwise
    expected counts ``xi_sum``: ``(R, K, K)`` — the complete E-step of
    Dirichlet VMP, in one kernel.

    Runs compiled on a GPU; elsewhere pass ``interpret=True``.
    """
    interpret = resolve_interpret(
        interpret, "hmm_forward_backward_counts_pallas"
    )
    tile = _plan(lik.shape[0], lik.shape[2], tile)
    return _forward_backward(lik, A, pi, True, tile, interpret)
