"""Time-sharded LGSSM smoothing: a distributed associative scan over the mesh.

The reference smooths a chain by sequential alternating sweeps
(``/root/reference/src/inference_engine.jl:575-607``).  Sharding the *time*
axis of a long chain across chips cannot use that recursion directly — instead
the chain's message passing is reformulated as an associative scan (see
:mod:`cortex_tpu.ops.chains`) and distributed in three steps:

1. each device runs a **local** associative scan over its time block,
2. the per-block combined elements (one small 5-tuple per device) are
   exchanged with a single ``all_gather`` over the ``time`` mesh axis — this
   is the *only* cross-device traffic; no halo exchange loops,
3. each device folds the exclusive prefix of the other blocks' elements into
   its local scan.

The same pattern runs in reverse for the smoother pass.  Results are exact —
bitwise-comparable to the single-device associative scan — and the collective
volume is O(num_devices), independent of chain length.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils import float32_matmuls

from ..ops.chains import (
    ChainMarginals,
    _FilterElem,
    _SmootherElem,
    _filter_combine,
    _smoother_combine,
)

__all__ = ["lgssm_smooth_time_sharded"]


def _filter_identity(like: jax.Array) -> _FilterElem:
    one = jnp.ones_like(like)
    zero = jnp.zeros_like(like)
    return _FilterElem(one, zero, zero, zero, zero)


def _smoother_identity(like: jax.Array) -> _SmootherElem:
    return _SmootherElem(jnp.ones_like(like), jnp.zeros_like(like), jnp.zeros_like(like))


def _exclusive_prefix(gathered, combine, identity, my_index, ndev):
    """Fold ``gathered[i]`` for ``i < my_index`` into a single element."""

    def body(i, acc):
        elem = jax.tree_util.tree_map(lambda a: a[i], gathered)
        combined = combine(acc, elem)
        return jax.tree_util.tree_map(
            lambda c, a: jnp.where(i < my_index, c, a), combined, acc
        )

    return lax.fori_loop(0, ndev, body, identity)


def _exclusive_suffix(gathered, combine, identity, my_index, ndev):
    """Fold ``gathered[i]`` for ``i > my_index`` into a single element
    (reverse direction: accumulate from the far end towards my block)."""

    def body(k, acc):
        i = ndev - 1 - k
        elem = jax.tree_util.tree_map(lambda a: a[i], gathered)
        combined = combine(acc, elem)
        return jax.tree_util.tree_map(
            lambda c, a: jnp.where(i > my_index, c, a), combined, acc
        )

    return lax.fori_loop(0, ndev, body, identity)


def lgssm_smooth_time_sharded(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    prior: Optional[Tuple[float, float]] = None,
) -> ChainMarginals:
    """Smooth ``y`` of shape ``(..., T)`` with T sharded over ``time_axis``.

    Exact Kalman/RTS marginals; per-sweep collective volume is one filter
    5-tuple and one smoother 3-tuple per device.
    """
    y = jnp.asarray(y)
    T = y.shape[-1]
    ndev = mesh.shape[time_axis]
    if T % ndev:
        raise ValueError(f"T={T} must divide evenly over {ndev} devices")

    batch_spec = (None,) * (y.ndim - 1)
    in_spec = P(*batch_spec, time_axis)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_spec,
        out_specs=(in_spec, in_spec),
    )
    def sharded(y_blk):
        # y_blk: (..., T/ndev) local block, time-major below.
        yT = jnp.moveaxis(y_blk, -1, 0)
        my = lax.axis_index(time_axis)

        # -- generic filter elements for every local step -----------------
        S = H * Q * H + R
        K = Q * H / S
        A_e = jnp.broadcast_to(jnp.asarray((1.0 - K * H) * A, y.dtype), yT.shape)
        b_e = K * yT
        C_e = jnp.broadcast_to(jnp.asarray((1.0 - K * H) * Q, y.dtype), yT.shape)
        eta_e = A * H * yT / S
        J_e = jnp.broadcast_to(jnp.asarray(A * H * H * A / S, y.dtype), yT.shape)

        # -- first global element is special (prior / first obs) ----------
        if prior is not None:
            m0 = jnp.broadcast_to(jnp.asarray(prior[0], y.dtype), yT.shape[1:])
            P0 = jnp.broadcast_to(jnp.asarray(prior[1], y.dtype), yT.shape[1:])
            S1 = H * P0 * H + R
            K1 = P0 * H / S1
            b1 = m0 + K1 * (yT[0] - H * m0)
            C1 = P0 - K1 * H * P0
        else:
            b1 = yT[0] / H
            C1 = jnp.broadcast_to(jnp.asarray(R / (H * H), y.dtype), yT.shape[1:])
        is_first = (my == 0)
        zeros0 = jnp.zeros_like(b1)
        A_e = A_e.at[0].set(jnp.where(is_first, zeros0, A_e[0]))
        b_e = b_e.at[0].set(jnp.where(is_first, b1, b_e[0]))
        C_e = C_e.at[0].set(jnp.where(is_first, C1, C_e[0]))
        eta_e = eta_e.at[0].set(jnp.where(is_first, zeros0, eta_e[0]))
        J_e = J_e.at[0].set(jnp.where(is_first, zeros0, J_e[0]))
        elems = _FilterElem(A_e, b_e, C_e, eta_e, J_e)

        # -- local scan + cross-device prefix fold -------------------------
        local = lax.associative_scan(_filter_combine, elems, axis=0)
        block_total = jax.tree_util.tree_map(lambda a: a[-1], local)
        gathered = lax.all_gather(block_total, time_axis)  # (ndev, ...)
        prefix = _exclusive_prefix(
            gathered, _filter_combine, _filter_identity(b1), my, ndev
        )
        prefix_b = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (yT.shape[0],) + a.shape), prefix
        )
        final = _filter_combine(prefix_b, local)
        fm, fP = final.b, final.C  # filtered means/vars for local block

        # -- smoother elements ---------------------------------------------
        Pp = A * A * fP + Q
        E = fP * A / Pp
        g = fm - E * A * fm
        L = fP - E * A * fP
        # The *global* last element is terminal: (0, fm_T, fP_T).
        is_last = (my == ndev - 1)
        E = E.at[-1].set(jnp.where(is_last, jnp.zeros_like(E[-1]), E[-1]))
        g = g.at[-1].set(jnp.where(is_last, fm[-1], g[-1]))
        L = L.at[-1].set(jnp.where(is_last, fP[-1], L[-1]))
        selems = _SmootherElem(E, g, L)

        slocal = lax.associative_scan(
            _smoother_combine, selems, axis=0, reverse=True
        )
        sblock_total = jax.tree_util.tree_map(lambda a: a[0], slocal)
        sgathered = lax.all_gather(sblock_total, time_axis)
        suffix = _exclusive_suffix(
            sgathered, _smoother_combine, _smoother_identity(b1), my, ndev
        )
        suffix_b = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (yT.shape[0],) + a.shape), suffix
        )
        sfinal = _smoother_combine(suffix_b, slocal)
        mean = jnp.moveaxis(sfinal.g, 0, -1)
        var = jnp.moveaxis(sfinal.L, 0, -1)
        return mean, var

    mean, var = sharded(y)
    return ChainMarginals(mean, var)


@float32_matmuls
def mv_lgssm_smooth_time_sharded(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior,
    *,
    mesh: Mesh,
    time_axis: str = "time",
    missing: str = "none",
):
    """Vector-state analogue of :func:`lgssm_smooth_time_sharded`.

    ``y``: ``(..., T, m)`` with T sharded over ``time_axis``; ``A, Q: (d,d)``,
    ``H: (m,d)``, ``R: (m,m)``, ``prior=(m0 (d,), P0 (d,d))``.  Exact
    marginals — one filter element (A, b, C, eta, J) and one smoother
    element (E, g, L) exchanged per device.  Per-device work runs in the
    lane-major layout (replicas on lanes; ``ops/chains_mv.py`` lane-major
    section): a sequential O(Tb) local fold + fill-in — the distributed
    form of :func:`cortex_tpu.ops.chains_mv.mv_lgssm_smooth_blocked`, with
    device index standing in for the block index.

    ``missing="none"`` (default): dense data only — the shared fast
    per-step elements assume every component observed, and NaNs propagate.
    ``missing="component"``: per-component NaN masking in information form
    (the same masked innovation systems as the single-chip paths'
    ``component_missing=True`` — a NaN in one observation component keeps
    the others' information; fully-NaN steps predict through), at the cost
    of per-step lane-major m-system solves in the element build.

    The lane-major element algebra shares the blocked path's d-crossover
    (its combine does d³ elementwise work — ``MvLGSSM.auto_method``):
    past d ≈ 8 a standard-layout per-device fold would win.
    """
    from ..ops.chains_mv import (
        MvChainMarginals,
        _Elem,
        _lcombine,
        _lfilter_fillin,
        _lmm,
        _lmv,
        _lscombine,
        _lseq_filter_total,
        _lseq_smoother_total,
        _lsmoother_fillin,
        _lsolve,
        _lT,
        _mT,
        _SElem,
        _solve_small,
    )

    if missing not in ("none", "component"):
        raise ValueError(
            f"unknown missing={missing!r}; expected 'none' or 'component'"
        )
    y = jnp.asarray(y)
    A, Q, H, R = map(jnp.asarray, (A, Q, H, R))
    m0, P0 = map(jnp.asarray, prior)
    d = A.shape[-1]
    mdim = H.shape[-2]
    T = y.shape[-2]
    ndev = mesh.shape[time_axis]
    if T % ndev:
        raise ValueError(f"T={T} must divide evenly over {ndev} devices")
    I = jnp.eye(d, dtype=y.dtype)

    batch_spec = (None,) * (y.ndim - 2)
    in_spec = P(*batch_spec, time_axis, None)
    out_mean_spec = P(*batch_spec, time_axis, None)
    out_cov_spec = P(*batch_spec, time_axis, None, None)

    @partial(jax.shard_map, mesh=mesh, in_specs=in_spec,
             out_specs=(out_mean_spec, out_cov_spec))
    def sharded(y_blk):
        Tb = y_blk.shape[-2]
        batch = y_blk.shape[:-2]
        # Flatten the replica batch onto the lane axis: (Tb, m, L).
        yL = jnp.moveaxis(y_blk.reshape((-1, Tb, mdim)), 0, -1)
        lanes = yL.shape[-1]
        my = lax.axis_index(time_axis)

        def lane(mat):
            return jnp.asarray(mat, y.dtype)[..., None]

        if missing == "component":
            # Per-step masked elements (H' = diag(c)H, R' = diag(c)Rdiag(c)
            # + diag(1-c)) — same embedding as the single-chip component
            # builders (``ops/chains_mv._build_filter_elems_lanes_component``);
            # per-step lane m-system solves instead of the shared elements.
            cL = (~jnp.isnan(yL)).astype(y.dtype)  # (Tb, m, L)
            yL = jnp.where(cL > 0, yL, 0.0)
            A_l, Q_l = lane(A), lane(Q)
            I_m = jnp.eye(mdim, dtype=y.dtype)[:, :, None]
            Hm = cL[:, :, None, :] * lane(H)  # (Tb, m, d, L)
            Rm = (
                cL[:, :, None, :] * cL[:, None, :, :] * lane(R)
                + (1.0 - cL)[:, :, None, :] * I_m
            )
            S_l = _lmm(_lmm(Hm, Q_l), _lT(Hm)) + Rm
            K_l = _lT(_lsolve(_lT(S_l), _lmm(Hm, _lT(Q_l))))
            IKH_l = I[:, :, None] - _lmm(K_l, Hm)
            HtSi_l = _lT(_lsolve(_lT(S_l), Hm))
            AtHtSi = _lmm(_lT(A_l), HtSi_l)
            A_e = _lmm(IKH_l, A_l)
            C_e = _lmm(IKH_l, Q_l)
            J_e = _lmm(_lmm(AtHtSi, Hm), A_l)
            b_e = _lmv(K_l, yL)
            eta_e = _lmv(AtHtSi, yL)

            # First global element: masked prior-conditioned belief of x_1.
            P0_l = lane(P0)
            m0_l = jnp.asarray(m0, y.dtype)[:, None]  # (d, 1)
            S1_l = _lmm(_lmm(Hm[0], P0_l), _lT(Hm[0])) + Rm[0]
            K1_l = _lT(_lsolve(_lT(S1_l), _lmm(Hm[0], _lT(P0_l))))
            b1 = m0_l + _lmv(
                K1_l,
                yL[0] - _lmv(Hm[0], jnp.broadcast_to(m0_l, (d, lanes))),
            )
            C1 = _lmm(I[:, :, None] - _lmm(K1_l, Hm[0]), P0_l)
        else:
            # Generic filter elements for all local steps (lane-major).
            S = H @ Q @ _mT(H) + R
            K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))
            IKH = I - K @ H
            HtSi = _mT(_solve_small(_mT(S), H, pivot=False))
            full = (Tb, d, d, lanes)
            A_e = jnp.broadcast_to(lane(IKH @ A), full)
            C_e = jnp.broadcast_to(lane(IKH @ Q), full)
            J_e = jnp.broadcast_to(lane(_mT(A) @ HtSi @ H @ A), full)
            b_e = jnp.einsum("dm,tmL->tdL", K.astype(y.dtype), yL)
            eta_e = jnp.einsum(
                "dm,tmL->tdL", (_mT(A) @ HtSi).astype(y.dtype), yL
            )

            # First global element: filtered belief of x_1 from the prior.
            S1 = H @ P0 @ _mT(H) + R
            K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))
            b1 = m0[:, None] + jnp.einsum(
                "dm,mL->dL", K1.astype(y.dtype), yL[0] - (H @ m0)[:, None]
            )
            C1 = jnp.broadcast_to(lane((I - K1 @ H) @ P0), (d, d, lanes))
        b1 = jnp.broadcast_to(b1, (d, lanes))
        C1 = jnp.broadcast_to(C1, (d, d, lanes))
        is_first = my == 0
        A_e = A_e.at[0].set(jnp.where(is_first, jnp.zeros_like(A_e[0]), A_e[0]))
        b_e = b_e.at[0].set(jnp.where(is_first, b1, b_e[0]))
        C_e = C_e.at[0].set(jnp.where(is_first, C1, C_e[0]))
        eta_e = eta_e.at[0].set(
            jnp.where(is_first, jnp.zeros_like(eta_e[0]), eta_e[0])
        )
        J_e = J_e.at[0].set(jnp.where(is_first, jnp.zeros_like(J_e[0]), J_e[0]))
        elems = _Elem(A_e, b_e, C_e, eta_e, J_e)

        def _filter_identity_like(varying_vec):
            # Built from a shard_map-varying array so the fori_loop carry
            # has consistent "varying manual axes" with the combines.
            zd = jnp.zeros_like(varying_vec)  # (d, L)
            zdd = zd[..., :, None, :] * zd[..., None, :, :]
            eye = I[:, :, None] + zdd
            return _Elem(eye, zd, zdd, zd, zdd)

        def _smoother_identity_like(varying_vec):
            zd = jnp.zeros_like(varying_vec)
            zdd = zd[..., :, None, :] * zd[..., None, :, :]
            return _SElem(I[:, :, None] + zdd, zd, zdd)

        # Local block total via a SEQUENTIAL fold — O(Tb) work, one combine
        # instance in the HLO (a local associative_scan would run
        # O(Tb log Tb) combines as an unrolled tiny-op network).
        ident = _filter_identity_like(b1)
        block_total = _lseq_filter_total(elems, ident)
        gathered = lax.all_gather(block_total, time_axis)
        prefix = _exclusive_prefix(gathered, _lcombine, ident, my, ndev)
        # Fill in the block from the entering belief (prefix has A = 0 for
        # every device but the first, where elem1 overwrites the zero
        # belief exactly) — one d-system solve per step.
        fm, fP = _lfilter_fillin(elems, prefix.b, prefix.C)

        # Smoother elements (lane-major; the LOCAL last element is a
        # regular one — it maps into the next device's first step — except
        # on the globally last device, where it is terminal).
        A_l = lane(A)
        Q_l = lane(Q)
        Pp = _lmm(_lmm(A_l, fP), _lT(A_l)) + Q_l
        G = _lT(_lsolve(_lT(Pp), _lmm(A_l, _lT(fP))))
        g = fm - _lmv(_lmm(G, A_l), fm)
        L = fP - _lmm(_lmm(G, Pp), _lT(G))
        is_last = my == ndev - 1
        G = G.at[-1].set(jnp.where(is_last, jnp.zeros_like(G[-1]), G[-1]))
        g = g.at[-1].set(jnp.where(is_last, fm[-1], g[-1]))
        L = L.at[-1].set(jnp.where(is_last, fP[-1], L[-1]))
        selems = _SElem(G, g, L)

        sident = _smoother_identity_like(b1)
        sblock_total = _lseq_smoother_total(selems, sident)
        sgathered = lax.all_gather(sblock_total, time_axis)
        suffix = _exclusive_suffix(sgathered, _lscombine, sident, my, ndev)
        # Smoothed moments at the block's LAST position, then 3-matmul
        # backward fill-in for the interior.
        e_last = jax.tree_util.tree_map(lambda a: a[-1], selems)
        slast = _lscombine(suffix, e_last)
        ms, Ps = _lsmoother_fillin(selems, slast.g, slast.L)
        # (Tb, d, L) / (Tb, d, d, L) -> (..., Tb, d) / (..., Tb, d, d).
        mean = jnp.moveaxis(ms, -1, 0).reshape(batch + (Tb, d))
        cov = jnp.moveaxis(Ps, -1, 0).reshape(batch + (Tb, d, d))
        return mean, cov

    mean, cov = sharded(y)
    return MvChainMarginals(mean, cov)
