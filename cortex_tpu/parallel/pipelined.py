"""Pipeline-parallel LGSSM smoothing: ppermute halo exchange between devices.

The reference smooths a chain by sequential alternating sweeps of one
message at a time (``/root/reference/src/inference_engine.jl:575-607``).
:mod:`cortex_tpu.parallel.time_sharded` removes the time recursion entirely
(associative scan + one ``all_gather``).  This module keeps the *sequential*
forward/backward recursion — the faithful analogue of the reference's sweep —
but distributes it as **pipeline parallelism** (the PP analogue from
SURVEY.md §2.3):

- the time axis is sharded into contiguous blocks, one per device on the
  ``time`` mesh axis (pipeline *stages*);
- the replica batch is split into *microbatches*;
- each stage runs the in-block ``lax.scan`` recursion for one microbatch,
  then hands the 2-scalar-per-replica boundary message (the filtered belief
  in information form) to the next stage with ``lax.ppermute`` — a pure
  halo exchange, no all-to-all traffic;
- the classic pipeline schedule overlaps stages: while stage 1 processes
  microbatch k, stage 0 processes microbatch k+1.  The bubble fraction is
  ``(n_stages - 1) / (n_stages + n_micro - 1)``.

The backward (RTS/backward-message) sweep runs the same pipeline mirrored.
Results are exact — identical marginals to :func:`lgssm_smooth_scan`.

When to prefer this over the associative-scan path: models whose step kernel
is *not* associative-scan-friendly (e.g. heavy nonlinear per-step work where
the O(log T) reformulation does not exist); for the linear chain itself the
``all_gather`` formulation is usually faster.  This module exists to pin the
pattern: sequential sweeps + ppermute boundary messages == pipeline-parallel
message passing.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.chains import ChainMarginals, _obs_message

__all__ = ["lgssm_smooth_pipelined"]


def _fwd_block(carry, xi_o, w_o, A, Q):
    """Run the forward message recursion over one local time block.

    ``carry`` is the filtered belief of the last state of the previous
    block, in information form ``(xi, w)``; the zero-information carry
    ``(0, 0)`` is the correct boundary for the first global block (the
    forward message into x_1 is "no message", `ops/chains.py`).
    Returns (carry_out, (xi_msgs, w_msgs)) with msgs shaped like ``xi_o``.
    """

    def step(c, obs):
        xi_f, w_f = c
        xi_obs_t, w_obs_t = obs
        denom = A * A + Q * w_f
        xi_msg = A * xi_f / denom
        w_msg = w_f / denom
        return (xi_msg + xi_obs_t, w_msg + w_obs_t), (xi_msg, w_msg)

    return lax.scan(step, carry, (xi_o, w_o))


def _bwd_block(carry, xi_o, w_o, A, Q):
    """Backward message recursion over one local block (time-reversed).

    ``carry`` is the product of obs and backward messages at the first
    state of the *next* block; ``(0, 0)`` is correct for the last global
    block (no backward message into x_T).
    ``xi_o``/``w_o`` are in natural (forward) time order; messages are
    returned in that order too.
    """

    def step(c, obs):
        xi_b, w_b = c
        xi_obs_t, w_obs_t = obs
        denom = 1.0 + Q * w_b
        xi_msg = A * xi_b / denom
        w_msg = A * A * w_b / denom
        return (xi_msg + xi_obs_t, w_msg + w_obs_t), (xi_msg, w_msg)

    carry_out, (xi_r, w_r) = lax.scan(step, carry, (xi_o[::-1], w_o[::-1]))
    return carry_out, (xi_r[::-1], w_r[::-1])


def _pipeline(xi_o, w_o, A, Q, *, stage, n_stage, n_micro, axis_name, forward):
    """Run one pipelined sweep over the local block; returns messages.

    ``xi_o``/``w_o``: (batch, T_blk) local observation messages.  The sweep
    carry (one (xi, w) pair per replica of the active microbatch) moves
    stage→stage+1 (forward) or stage→stage-1 (backward) via ``ppermute``
    after every pipeline step.  Devices outside the permutation receive
    zeros — exactly the zero-information boundary carry.
    """
    B = xi_o.shape[0]
    mb = B // n_micro
    block = _fwd_block if forward else _bwd_block
    if forward:
        perm = [(d, d + 1) for d in range(n_stage - 1)]
        my_pos = stage
    else:
        perm = [(d, d - 1) for d in range(1, n_stage)]
        my_pos = (n_stage - 1) - stage

    out_xi = jnp.zeros_like(xi_o)
    out_w = jnp.zeros_like(w_o)
    # The carry is device-varying state under shard_map (each stage holds a
    # different boundary message), so the all-zeros init must be stamped as
    # varying over the mesh axis for the scan carry types to match.
    zeros = (jnp.zeros((mb,), xi_o.dtype), jnp.zeros((mb,), w_o.dtype))
    if hasattr(lax, "pcast"):
        carry = lax.pcast(zeros, (axis_name,), to="varying")
    else:  # older JAX
        carry = lax.pvary(zeros, (axis_name,))

    for s in range(n_stage + n_micro - 1):
        m = s - my_pos  # microbatch index this stage works on (traced)
        mc = jnp.clip(m, 0, n_micro - 1)
        start = mc * mb
        xi_mb = lax.dynamic_slice_in_dim(xi_o, start, mb, axis=0)
        w_mb = lax.dynamic_slice_in_dim(w_o, start, mb, axis=0)
        # block works time-major: pass (T_blk, mb), get msgs back the same.
        carry_out, (xi_msgs, w_msgs) = block(carry, xi_mb.T, w_mb.T, A, Q)
        xi_msgs, w_msgs = xi_msgs.T, w_msgs.T

        valid = (m >= 0) & (m < n_micro)
        old_xi = lax.dynamic_slice_in_dim(out_xi, start, mb, axis=0)
        old_w = lax.dynamic_slice_in_dim(out_w, start, mb, axis=0)
        out_xi = lax.dynamic_update_slice_in_dim(
            out_xi, jnp.where(valid, xi_msgs, old_xi), start, axis=0
        )
        out_w = lax.dynamic_update_slice_in_dim(
            out_w, jnp.where(valid, w_msgs, old_w), start, axis=0
        )
        # Halo exchange: boundary belief to the next pipeline stage.
        carry = lax.ppermute(carry_out, axis_name, perm)

    return out_xi, out_w


def lgssm_smooth_pipelined(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    n_micro: Optional[int] = None,
    prior: Optional[Tuple[float, float]] = None,
) -> ChainMarginals:
    """Pipeline-parallel BP smoothing of ``y`` shaped ``(batch, T)``.

    ``T`` is sharded over ``time_axis`` (pipeline stages); the replica
    ``batch`` axis is split into ``n_micro`` microbatches (default: the
    number of stages).  Exact Kalman/RTS marginals.
    """
    y = jnp.asarray(y)
    if y.ndim != 2:
        raise ValueError(f"pipelined smoothing expects (batch, T), got {y.shape}")
    B, T = y.shape
    n_stage = mesh.shape[time_axis]
    if T % n_stage:
        raise ValueError(f"T={T} must divide evenly over {n_stage} stages")
    n_micro = n_stage if n_micro is None else n_micro
    if B % n_micro:
        raise ValueError(f"batch={B} must divide into {n_micro} microbatches")

    in_spec = P(None, time_axis)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_spec,
        out_specs=(in_spec, in_spec),
    )
    def sharded(y_blk):
        stage = lax.axis_index(time_axis)
        xi_o, w_o = _obs_message(y_blk, H, R)  # (B, T_blk)
        if prior is not None:
            pm, pv = prior
            first = (stage == 0)
            xi_o = xi_o.at[:, 0].add(jnp.where(first, pm / pv, 0.0))
            w_o = w_o.at[:, 0].add(jnp.where(first, 1.0 / pv, 0.0))

        run = partial(
            _pipeline,
            xi_o,
            w_o,
            A,
            Q,
            stage=stage,
            n_stage=n_stage,
            n_micro=n_micro,
            axis_name=time_axis,
        )
        xi_f, w_f = run(forward=True)
        xi_b, w_b = run(forward=False)

        xi_m = xi_o + xi_f + xi_b
        w_m = w_o + w_f + w_b
        return xi_m / w_m, 1.0 / w_m

    mean, var = sharded(y)
    return ChainMarginals(mean, var)
