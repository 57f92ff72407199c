"""Vector-state LGSSM smoothing: time-parallel associative scan with matrices.

Generalizes :mod:`cortex_tpu.ops.chains` to d-dimensional states and
m-dimensional observations:

    x_t = A x_{t-1} + N(0, Q),    y_t = H x_t + N(0, R)

using the parallel Kalman filter/smoother elements (Särkkä &
García-Fernández 2020) with matrix combines — ``d×d`` solves and matmuls
batched over replicas.  The multivariate counterpart of
the reference's 2-D joint-marginal computations
(``test/inference_engine_tests.jl:949-979``), lifted to whole chains.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils import float32_matmuls

__all__ = [
    "MvChainMarginals",
    "MvSmootherOperator",
    "mv_lgssm_filter",
    "mv_lgssm_log_evidence",
    "mv_lgssm_smooth",
    "mv_lgssm_smooth_blocked",
    "mv_lgssm_smooth_seq",
    "mv_lgssm_smooth_matmul",
    "mv_lgssm_smoother_operator",
]


class MvChainMarginals(NamedTuple):
    mean: jax.Array  # (..., T, d)
    cov: jax.Array  # (..., T, d, d)


class _Elem(NamedTuple):
    A: jax.Array
    b: jax.Array
    C: jax.Array
    eta: jax.Array
    J: jax.Array


def _solve_small(M: jax.Array, B: jax.Array, pivot: bool = True) -> jax.Array:
    """Batched ``solve(M, B)`` for small static ``d`` via unrolled
    Gauss-Jordan.

    ``jnp.linalg.solve`` lowers to an LU custom call, instantiated dozens of
    times inside an unrolled ``associative_scan`` and once per step inside a
    ``lax.scan``.  For the d ≤ 16 systems of the smoother combines, ``d``
    unrolled elimination steps of elementwise ops batch over replicas with no
    custom call.  (Chosen for the compile time of the first accelerator this
    ran on; on the H100 the choice against batched LU is not measured.)
    Falls back to the LU path above d = 32.

    ``pivot=False`` drops the partial-pivoting row swaps (an argmax +
    row-gather per step, the larger part of the compile cost).  Only valid
    when every leading principal pivot is structurally nonzero — true for
    the smoother's systems: ``M = I + C @ J`` with C, J PSD has eigenvalues
    ≥ 1, and predicted covariances are SPD.  The general default pivots."""
    d = M.shape[-1]
    if d > 32:
        return jnp.linalg.solve(M, B)
    aug = jnp.concatenate([M, B], axis=-1)  # (..., d, d+k)
    idx = jnp.arange(d)
    for i in range(d):
        if pivot:
            col = jnp.abs(aug[..., :, i])
            col = jnp.where(idx >= i, col, -jnp.inf)  # among rows >= i
            p = jnp.argmax(col, axis=-1)[..., None]  # (..., 1)
            perm = jnp.where(idx == i, p, jnp.where(idx == p, i, idx))
            aug = jnp.take_along_axis(aug, perm[..., :, None], axis=-2)
        piv_row = aug[..., i : i + 1, :]
        piv_row = piv_row / piv_row[..., :, i : i + 1]
        factors = aug[..., :, i : i + 1]
        is_i = (idx == i)[:, None]
        aug = jnp.where(is_i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:]


def _solve_small_logdet(M: jax.Array, B: jax.Array):
    """Pivotless :func:`_solve_small` that also returns ``log |det M|``
    (the running product of elimination pivots) — the Kalman update needs
    ``S⁻¹`` systems AND ``log det S`` for the evidence, and this gets both
    from one elimination with zero LU/Cholesky custom calls.  Requires the
    structurally-nonzero-pivot condition of ``pivot=False`` (S is SPD).

    Above d = 32 falls back to a Cholesky solve (S is SPD here, so the
    factorization is exact and ``log det = 2 Σ log diag(L)``) — mirroring
    :func:`_solve_small`'s own fallback so large observation dims don't
    unroll an O(d) elimination network at compile time."""
    d = M.shape[-1]
    if d > 32:
        L = jnp.linalg.cholesky(M)
        sol = jax.scipy.linalg.cho_solve((L, True), B)
        logdet = 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
        )
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


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Matrix filtering combine (Särkkä 2020 eq. 10); e1 earlier, e2 later.

    On pivoting: ``M = I + C @ J`` with C, J PSD is always nonsingular
    (``CJ`` shares its nonzero spectrum with the PSD ``J^{1/2} C J^{1/2}``,
    so ``spec(M) ⊆ [1, ∞)``), which guarantees the *pivoted* elimination.
    Pivotless elimination additionally needs nonzero leading principal
    minors — NOT implied by PSD alone (rank-deficient C with adversarial J
    can zero the (1,1) entry), but in these combines C is a filtered /
    predicted covariance kept SPD by construction (re-symmetrization, SPD
    priors, Q ≻ 0) and the minors stay bounded away from zero; the
    fuzz/parity suites (test_chains_mv, test_missing_data, test_parallel)
    exercise this across models.  Callers with near-singular covariance
    models should prefer the square-root path (ops/sqrt_kalman.py)."""
    d = e1.A.shape[-1]
    I = jnp.eye(d, dtype=e1.A.dtype)
    M = I + e1.C @ e2.J  # (..., d, d)
    # One shared elimination for the three M-systems (stack on the k axis).
    rhs = jnp.concatenate(
        [
            e1.A,
            (e1.b + (e1.C @ e2.eta[..., None])[..., 0])[..., None],
            e1.C,
        ],
        axis=-1,
    )
    sol = _solve_small(M, rhs, pivot=False)
    MA, Mb, MC = sol[..., :d], sol[..., d : d + 1], sol[..., d + 1 :]
    A = e2.A @ MA
    b = (e2.A @ Mb)[..., 0] + e2.b
    C = e2.A @ MC @ _mT(e2.A) + e2.C
    Mt = I + e2.J @ e1.C
    rhs_t = jnp.concatenate(
        [(e2.eta - (e2.J @ e1.b[..., None])[..., 0])[..., None], e2.J],
        axis=-1,
    )
    sol_t = _solve_small(Mt, rhs_t, pivot=False)
    eta = (_mT(e1.A) @ sol_t[..., :1])[..., 0] + e1.eta
    J = _mT(e1.A) @ sol_t[..., 1:] @ e1.A + e1.J
    return _Elem(A, b, C, eta, J)


class _SElem(NamedTuple):
    E: jax.Array
    g: jax.Array
    L: jax.Array


def _scombine(e1: _SElem, e2: _SElem) -> _SElem:
    """Smoother combine, reverse direction; e1 later (closer to T), e2
    earlier."""
    return _SElem(
        e2.E @ e1.E,
        (e2.E @ e1.g[..., None])[..., 0] + e2.g,
        e2.E @ e1.L @ _mT(e2.E) + e2.L,
    )


def _mT(x: jax.Array) -> jax.Array:
    return jnp.swapaxes(x, -1, -2)


def _build_filter_elems_component(y, A, Q, H, R, m0, P0) -> _Elem:
    """Per-step filter elements under PER-COMPONENT missingness.

    General form of :func:`_build_filter_elems`: every step gets its own
    masked observation model ``H'_t = diag(c_t) H``,
    ``R'_t = diag(c_t) R diag(c_t) + diag(1-c_t)`` (same embedding as
    :func:`_mv_filter_scan`), so the per-step innovation system
    ``S_t = H'_t Q H'_tᵀ + R'_t`` is solved per step instead of once —
    the price of dense per-component gaps on the time-parallel paths
.  A fully-observed step reproduces the shared
    element exactly; a fully-missing step degenerates to pure prediction
    ``(A, 0, Q, 0, 0)``."""
    d = A.shape[-1]
    mdim = H.shape[-2]
    cmask = ~jnp.isnan(y)  # (..., T, m)
    y = jnp.where(cmask, y, 0.0)
    yT = jnp.moveaxis(y, -2, 0)  # (T, ..., m)
    cT = jnp.moveaxis(cmask, -2, 0).astype(y.dtype)  # (T, ..., m)
    batch = yT.shape[1:-1]
    I = jnp.eye(d, dtype=y.dtype)
    eye_m = jnp.eye(mdim, dtype=y.dtype)

    def masked_obs(c):
        Hm = c[..., :, None] * H
        Rm = c[..., :, None] * c[..., None, :] * R + (1.0 - c)[
            ..., :, None
        ] * eye_m
        return Hm, Rm

    # Elements t >= 2: predict with (A, Q), update with the masked model.
    Hm, Rm = masked_obs(cT[1:])  # (T-1, ..., m, ·)
    S = Hm @ Q @ _mT(Hm) + Rm
    K = _mT(_solve_small(_mT(S), Hm @ _mT(Q), pivot=False))  # Q H'ᵀ S⁻¹
    IKH = I - K @ Hm
    HtSi = _mT(_solve_small(_mT(S), Hm, pivot=False))  # H'ᵀ S⁻¹
    AtHtSi = _mT(A) @ HtSi  # (T-1, ..., d, m)
    elems_rest = _Elem(
        IKH @ A,
        jnp.einsum("t...dm,t...m->t...d", K, yT[1:]),
        IKH @ Q,
        jnp.einsum("t...dm,t...m->t...d", AtHtSi, yT[1:]),
        AtHtSi @ Hm @ A,
    )

    # First element: filtered belief of x_1 under the prior.
    Hm1, Rm1 = masked_obs(cT[0])
    S1 = Hm1 @ P0 @ _mT(Hm1) + Rm1
    K1 = _mT(_solve_small(_mT(S1), Hm1 @ _mT(P0), pivot=False))
    b1 = m0 + jnp.einsum(
        "...dm,...m->...d", K1, yT[0] - jnp.einsum("...md,d->...m", Hm1, m0)
    )
    C1 = (I - K1 @ Hm1) @ P0
    zeros_d = jnp.zeros(batch + (d,), y.dtype)
    zeros_dd = jnp.zeros(batch + (d, d), y.dtype)
    elem1 = _Elem(
        zeros_dd,
        jnp.broadcast_to(b1, batch + (d,)),
        jnp.broadcast_to(C1, batch + (d, d)),
        zeros_d,
        zeros_dd,
    )
    return jax.tree_util.tree_map(
        lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
        elem1,
        elems_rest,
    )


def _build_filter_elems(y, A, Q, H, R, m0, P0, component_missing=False) -> _Elem:
    """Per-step parallel-filter elements, time-major ``(T, ..., ·)``.

    Element t composes the predict+update map of step t; element 1 is the
    prior-conditioned filtered belief of x₁ (A = 0).  Time steps whose
    observation vector contains any NaN degenerate to the pure prediction
    element (A, 0, Q, 0, 0); pass ``component_missing=True`` for dense
    per-component gaps (:func:`_build_filter_elems_component` — per-step
    innovation solves instead of the shared fast elements below)."""
    if component_missing:
        return _build_filter_elems_component(y, A, Q, H, R, m0, P0)
    d = A.shape[-1]
    T = y.shape[-2]
    observed = ~jnp.any(jnp.isnan(y), axis=-1)  # (..., T)
    y = jnp.where(observed[..., None], y, 0.0)
    obsT = jnp.moveaxis(observed, -1, 0)  # (T, ...)
    yT = jnp.moveaxis(y, -2, 0)  # (T, ..., m)
    batch = yT.shape[1:-1]
    I = jnp.eye(d, dtype=y.dtype)

    # Generic elements (t >= 2); identical for all steps except the data term.
    S = H @ Q @ _mT(H) + R  # (m, m)
    K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))  # Q Hᵀ S⁻¹, (d, m)
    IKH = I - K @ H
    A_g = IKH @ A
    C_g = IKH @ Q
    HtSi = _mT(_solve_small(_mT(S), H, pivot=False))  # Hᵀ S⁻¹, (d, m)
    eta_coef = _mT(A) @ HtSi  # (d, m)
    J_g = _mT(A) @ HtSi @ H @ A  # (d, d)

    b_g = jnp.einsum("dm,t...m->t...d", K, yT[1:])
    eta_g = jnp.einsum("dm,t...m->t...d", eta_coef, yT[1:])

    def bcast(mat, leading):
        return jnp.broadcast_to(mat, leading + mat.shape)

    n_rest = (T - 1,) + batch
    mrest = obsT[1:][..., None, None]  # (T-1, ..., 1, 1)
    elems_rest = _Elem(
        jnp.where(mrest, bcast(A_g, n_rest), jnp.broadcast_to(A, n_rest + A.shape)),
        jnp.where(mrest[..., 0], b_g, 0.0),
        jnp.where(mrest, bcast(C_g, n_rest), jnp.broadcast_to(Q, n_rest + Q.shape)),
        jnp.where(mrest[..., 0], eta_g, 0.0),
        jnp.where(mrest, bcast(J_g, n_rest), 0.0),
    )

    # First element: filtered belief of x_1 under the prior (prior alone if
    # the first observation is missing).
    S1 = H @ P0 @ _mT(H) + R
    K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))  # P0 Hᵀ S1⁻¹
    m1 = obsT[0][..., None, None]
    b1 = m0 + jnp.where(
        m1[..., 0], jnp.einsum("dm,...m->...d", K1, yT[0] - H @ m0), 0.0
    )
    C1 = jnp.where(m1, (I - K1 @ H) @ P0, P0)
    zeros_d = jnp.zeros(batch + (d,), y.dtype)
    zeros_dd = jnp.zeros(batch + (d, d), y.dtype)
    elem1 = _Elem(
        zeros_dd,
        jnp.broadcast_to(b1, batch + (d,)),
        jnp.broadcast_to(C1, batch + (d, d)),
        zeros_d,
        zeros_dd,
    )
    return jax.tree_util.tree_map(
        lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
        elem1,
        elems_rest,
    )


def _build_smoother_elems(fm, fP, A, Q) -> _SElem:
    """Backward (RTS) affine elements from time-major filtered moments
    ``fm (T, ..., d)``, ``fP (T, ..., d, d)``: element t maps the smoothed
    belief at t+1 to t; the terminal element is the constant filtered
    belief at T."""
    Pp = A @ fP[:-1] @ _mT(A) + Q  # predicted covs
    G = _mT(_solve_small(_mT(Pp), A @ _mT(fP[:-1]), pivot=False))  # P_f Aᵀ Pp⁻¹
    g = fm[:-1] - jnp.einsum("t...ij,t...j->t...i", G @ A, fm[:-1])
    L = fP[:-1] - G @ Pp @ _mT(G)
    # Terminal element from fP[:1] (NOT G[:1]: G is empty when T = 1).
    return _SElem(
        jnp.concatenate([G, jnp.zeros_like(fP[:1])], axis=0),
        jnp.concatenate([g, fm[-1:]], axis=0),
        jnp.concatenate([L, fP[-1:]], axis=0),
    )


# ---------------------------------------------------------------------------
# Lane-major element algebra: replicas on lanes.
#
# Leaves are laid out ``(..., d, d, R)`` / ``(..., d, R)`` with the replica
# axis LAST, so the minor (contiguous) dimension is the long replica axis
# and the tiny d×d matrix algebra unrolls into elementwise multiply-adds
# over whole replica rows, instead of operating on (d, d)-minor arrays.
# ---------------------------------------------------------------------------


def _lT(a: jax.Array) -> jax.Array:
    """Matrix transpose in lane layout: swap the (row, col) axes -3/-2."""
    return jnp.swapaxes(a, -3, -2)


def _lmm(a: jax.Array, b: jax.Array) -> jax.Array:
    """``(..., i, k, R) @ (..., k, j, R) -> (..., i, j, R)`` as unrolled
    multiply-adds over the replica axis (d³ elementwise ops, no matmul,
    no relayout)."""
    return (a[..., :, :, None, :] * b[..., None, :, :, :]).sum(-3)


def _lmv(a: jax.Array, v: jax.Array) -> jax.Array:
    """``(..., i, k, R) @ (..., k, R) -> (..., i, R)``."""
    return (a * v[..., None, :, :]).sum(-2)


def _lsolve(M: jax.Array, B: jax.Array) -> jax.Array:
    """Pivotless Gauss-Jordan ``solve(M, B)`` in lane layout:
    ``M (..., d, d, R)``, ``B (..., d, k, R)``.  Same validity condition as
    :func:`_solve_small` with ``pivot=False`` (see :func:`_combine`)."""
    d = M.shape[-3]
    aug = jnp.concatenate([M, B], axis=-2)
    rows = jnp.arange(d)[:, None, None]
    for i in range(d):
        piv_row = aug[..., i : i + 1, :, :] / aug[..., i : i + 1, i : i + 1, :]
        factors = aug[..., :, i : i + 1, :]
        aug = jnp.where(rows == i, piv_row, aug - factors * piv_row)
    return aug[..., :, d:, :]


def _lcombine(e1: _Elem, e2: _Elem) -> _Elem:
    """:func:`_combine` in lane layout (e1 earlier, e2 later)."""
    d = e1.A.shape[-3]
    I = jnp.eye(d, dtype=e1.A.dtype)[:, :, None]
    M = I + _lmm(e1.C, e2.J)
    rhs = jnp.concatenate(
        [e1.A, (e1.b + _lmv(e1.C, e2.eta))[..., :, None, :], e1.C], axis=-2
    )
    sol = _lsolve(M, rhs)
    MA, Mb, MC = sol[..., :, :d, :], sol[..., :, d, :], sol[..., :, d + 1 :, :]
    A = _lmm(e2.A, MA)
    b = _lmv(e2.A, Mb) + e2.b
    C = _lmm(_lmm(e2.A, MC), _lT(e2.A)) + e2.C
    Mt = I + _lmm(e2.J, e1.C)
    rhs_t = jnp.concatenate(
        [(e2.eta - _lmv(e2.J, e1.b))[..., :, None, :], e2.J], axis=-2
    )
    sol_t = _lsolve(Mt, rhs_t)
    eta = _lmv(_lT(e1.A), sol_t[..., :, 0, :]) + e1.eta
    J = _lmm(_lmm(_lT(e1.A), sol_t[..., :, 1:, :]), e1.A) + e1.J
    return _Elem(A, b, C, eta, J)


def _lscombine(e1: _SElem, e2: _SElem) -> _SElem:
    """:func:`_scombine` in lane layout (e1 later, e2 earlier)."""
    return _SElem(
        _lmm(e2.E, e1.E),
        _lmv(e2.E, e1.g) + e2.g,
        _lmm(_lmm(e2.E, e1.L), _lT(e2.E)) + e2.L,
    )


def _build_filter_elems_lanes_component(y, A, Q, H, R, m0, P0):
    """Lane-major :func:`_build_filter_elems_component`: per-component
    masked elements with replicas on lanes — per-step m-system solves in
    lane layout (``_lsolve``) instead of the shared fast elements."""
    d = A.shape[-1]
    T, m = y.shape[-2], y.shape[-1]
    batch = y.shape[:-2]
    yL = jnp.moveaxis(y.reshape((-1, T, m)), 0, -1)  # (T, m, L)
    cL = (~jnp.isnan(yL)).astype(y.dtype)  # (T, m, L)
    yL = jnp.where(cL > 0, yL, 0.0)
    L = yL.shape[-1]
    A_l = jnp.asarray(A, y.dtype)[..., None]  # (d, d, 1)
    Q_l = jnp.asarray(Q, y.dtype)[..., None]
    H_l = jnp.asarray(H, y.dtype)[..., None]  # (m, d, 1)
    R_l = jnp.asarray(R, y.dtype)[..., None]
    I_d = jnp.eye(d, dtype=y.dtype)[:, :, None]
    I_m = jnp.eye(m, dtype=y.dtype)[:, :, None]

    def masked_obs(c):  # c: (..., m, L)
        Hm = c[..., :, None, :] * H_l  # (..., m, d, L)
        Rm = (
            c[..., :, None, :] * c[..., None, :, :] * R_l
            + (1.0 - c)[..., :, None, :] * I_m
        )
        return Hm, Rm

    # Elements t >= 2.
    Hm, Rm = masked_obs(cL[1:])  # (T-1, m, ·, L)
    S = _lmm(_lmm(Hm, Q_l), _lT(Hm)) + Rm
    K = _lT(_lsolve(_lT(S), _lmm(Hm, _lT(Q_l))))  # Q H'ᵀ S⁻¹, (T-1, d, m, L)
    IKH = I_d - _lmm(K, Hm)
    HtSi = _lT(_lsolve(_lT(S), Hm))  # H'ᵀ S⁻¹, (T-1, d, m, L)
    AtHtSi = _lmm(_lT(A_l), HtSi)
    elems_rest = _Elem(
        _lmm(IKH, A_l),
        _lmv(K, yL[1:]),
        _lmm(IKH, Q_l),
        _lmv(AtHtSi, yL[1:]),
        _lmm(_lmm(AtHtSi, Hm), A_l),
    )

    # First element: prior-conditioned filtered belief of x_1 (A = 0).
    P0_l = jnp.asarray(P0, y.dtype)[..., None]
    m0_l = jnp.asarray(m0, y.dtype)[..., None]  # (d, 1)
    Hm1, Rm1 = masked_obs(cL[0])
    S1 = _lmm(_lmm(Hm1, P0_l), _lT(Hm1)) + Rm1
    K1 = _lT(_lsolve(_lT(S1), _lmm(Hm1, _lT(P0_l))))  # (d, m, L)
    b1 = m0_l + _lmv(K1, yL[0] - _lmv(Hm1, jnp.broadcast_to(m0_l, (d, L))))
    C1 = _lmm(I_d - _lmm(K1, Hm1), P0_l)
    elem1 = _Elem(
        jnp.zeros((d, d, L), y.dtype),
        jnp.broadcast_to(b1, (d, L)),
        jnp.broadcast_to(C1, (d, d, L)),
        jnp.zeros((d, L), y.dtype),
        jnp.zeros((d, d, L), y.dtype),
    )
    elems = jax.tree_util.tree_map(
        lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
        elem1,
        elems_rest,
    )
    return elems, batch


def _build_filter_elems_lanes(
    y, A, Q, H, R, m0, P0, component_missing=False
) -> Tuple[_Elem, tuple]:
    """Lane-major :func:`_build_filter_elems`: ``y (..., T, m)`` with all
    leading batch dims flattened onto the lane axis; returns elements with
    leaves ``(T, d, d, L)`` / ``(T, d, L)`` plus the original batch shape.
    ``component_missing=True`` routes to the per-component masked builder
    (:func:`_build_filter_elems_lanes_component`)."""
    if component_missing:
        return _build_filter_elems_lanes_component(y, A, Q, H, R, m0, P0)
    d = A.shape[-1]
    T, m = y.shape[-2], y.shape[-1]
    batch = y.shape[:-2]
    yL = jnp.moveaxis(y.reshape((-1, T, m)), 0, -1)  # (T, m, L)
    observed = ~jnp.any(jnp.isnan(yL), axis=-2)  # (T, L)
    yL = jnp.where(observed[..., None, :], yL, 0.0)
    L = yL.shape[-1]

    def lane(mat):  # (r, c) constant -> (r, c, 1)
        return jnp.asarray(mat, y.dtype)[..., None]

    # Generic per-step quantities (time-invariant model).
    S = H @ Q @ _mT(H) + R
    K = _mT(_solve_small(_mT(S), H @ _mT(Q), pivot=False))  # (d, m)
    IKH = jnp.eye(d, dtype=y.dtype) - K @ H
    HtSi = _mT(_solve_small(_mT(S), H, pivot=False))  # (d, m)
    A_g, C_g = lane(IKH @ A), lane(IKH @ Q)
    J_g = lane(_mT(A) @ HtSi @ H @ A)
    b_g = jnp.einsum("dm,tmL->tdL", K.astype(y.dtype), yL[1:])
    eta_g = jnp.einsum("dm,tmL->tdL", (_mT(A) @ HtSi).astype(y.dtype), yL[1:])

    mrest = observed[1:, None, None, :]  # (T-1, 1, 1, L)
    full = (T - 1, d, d, L)
    elems_rest = _Elem(
        jnp.where(mrest, jnp.broadcast_to(A_g, full), jnp.broadcast_to(lane(A), full)),
        jnp.where(mrest[..., 0, :], b_g, 0.0),
        jnp.where(mrest, jnp.broadcast_to(C_g, full), jnp.broadcast_to(lane(Q), full)),
        jnp.where(mrest[..., 0, :], eta_g, 0.0),
        jnp.where(mrest, jnp.broadcast_to(J_g, full), 0.0),
    )

    # First element: prior-conditioned filtered belief of x_1 (A = 0).
    S1 = H @ P0 @ _mT(H) + R
    K1 = _mT(_solve_small(_mT(S1), H @ _mT(P0), pivot=False))  # (d, m)
    m1 = observed[0]  # (L,)
    innov1 = yL[0] - (H @ m0)[:, None]  # (m, L)
    b1 = m0[:, None] + jnp.where(
        m1, jnp.einsum("dm,mL->dL", K1.astype(y.dtype), innov1), 0.0
    )
    C1 = jnp.where(
        m1,
        jnp.broadcast_to(lane((jnp.eye(d, dtype=y.dtype) - K1 @ H) @ P0), (d, d, L)),
        jnp.broadcast_to(lane(P0), (d, d, L)),
    )
    zd = jnp.zeros((d, L), y.dtype)
    zdd = jnp.zeros((d, d, L), y.dtype)
    elem1 = _Elem(zdd, b1, C1, zd, zdd)
    elems = jax.tree_util.tree_map(
        lambda a, rest: jnp.concatenate([a[None], rest], axis=0),
        elem1,
        elems_rest,
    )
    return elems, batch


def _build_smoother_elems_lanes(fm, fP, A, Q) -> _SElem:
    """Lane-major :func:`_build_smoother_elems`: ``fm (T, ..., d, L)``,
    ``fP (T, ..., d, d, L)``."""
    A_l = jnp.asarray(A, fm.dtype)[..., None]
    Q_l = jnp.asarray(Q, fm.dtype)[..., None]
    Pp = _lmm(_lmm(A_l, fP[:-1]), _lT(A_l)) + Q_l
    G = _lT(_lsolve(_lT(Pp), _lmm(A_l, _lT(fP[:-1]))))  # P_f Aᵀ Pp⁻¹
    g = fm[:-1] - _lmv(_lmm(G, A_l), fm[:-1])
    L = fP[:-1] - _lmm(_lmm(G, Pp), _lT(G))
    # Terminal element from fP[:1] (NOT G[:1]: G is empty when T = 1).
    return _SElem(
        jnp.concatenate([G, jnp.zeros_like(fP[:1])], axis=0),
        jnp.concatenate([g, fm[-1:]], axis=0),
        jnp.concatenate([L, fP[-1:]], axis=0),
    )


def _lelem_identity(batch, d, lanes, dtype) -> _Elem:
    eye = jnp.broadcast_to(
        jnp.eye(d, dtype=dtype)[:, :, None], batch + (d, d, lanes)
    )
    zd = jnp.zeros(batch + (d, lanes), dtype)
    zdd = jnp.zeros(batch + (d, d, lanes), dtype)
    return _Elem(eye, zd, zdd, zd, zdd)


def _lselem_identity(batch, d, lanes, dtype) -> _SElem:
    eye = jnp.broadcast_to(
        jnp.eye(d, dtype=dtype)[:, :, None], batch + (d, d, lanes)
    )
    return _SElem(
        eye,
        jnp.zeros(batch + (d, lanes), dtype),
        jnp.zeros(batch + (d, d, lanes), dtype),
    )


def _lseq_filter_total(elems: _Elem, ident: _Elem) -> _Elem:
    """Sequential fold of lane-major elements (one combine in the HLO)."""
    total, _ = lax.scan(lambda c, e: (_lcombine(c, e), None), ident, elems)
    return total


def _lseq_smoother_total(selems: _SElem, ident: _SElem) -> _SElem:
    total, _ = lax.scan(
        lambda c, e: (_lscombine(c, e), None), ident, selems, reverse=True
    )
    return total


def _lapply_filter_elem(b, C, e: _Elem):
    """Lane-major :func:`_apply_filter_elem` (one d-system solve)."""
    d = C.shape[-3]
    I = jnp.eye(d, dtype=C.dtype)[:, :, None]
    M = I + _lmm(C, e.J)
    rhs = jnp.concatenate([(b + _lmv(C, e.eta))[..., :, None, :], C], axis=-2)
    sol = _lsolve(M, rhs)
    nb = _lmv(e.A, sol[..., :, 0, :]) + e.b
    nC = _lmm(_lmm(e.A, sol[..., :, 1:, :]), _lT(e.A)) + e.C
    nC = 0.5 * (nC + _lT(nC))
    return nb, nC


def _lfilter_fillin(elems: _Elem, b0, C0):
    def step(carry, e):
        nb, nC = _lapply_filter_elem(carry[0], carry[1], e)
        return (nb, nC), (nb, nC)

    _, (fb, fC) = lax.scan(step, (b0, C0), elems)
    return fb, fC


def _lsmoother_fillin(selems: _SElem, last_g, last_L):
    def step(carry, e):
        ms, Ps = carry
        nm = _lmv(e.E, ms) + e.g
        nP = _lmm(_lmm(e.E, Ps), _lT(e.E)) + e.L
        return (nm, nP), (nm, nP)

    head = jax.tree_util.tree_map(lambda a: a[:-1], selems)
    _, (ms, Ps) = lax.scan(step, (last_g, last_L), head, reverse=True)
    return (
        jnp.concatenate([ms, last_g[None]], axis=0),
        jnp.concatenate([Ps, last_L[None]], axis=0),
    )


@float32_matmuls
def mv_lgssm_smooth(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
    *,
    component_missing: bool = False,
) -> MvChainMarginals:
    """Exact RTS-equivalent marginals for a vector-state LGSSM.

    Parameters
    ----------
    y: ``(..., T, m)`` observations (leading axes = replicas).
    A, Q: ``(d, d)`` transition matrix / noise covariance.
    H: ``(m, d)`` observation matrix; R: ``(m, m)`` observation noise.
    prior: ``(m0 (d,), P0 (d, d))`` prior on the first state.
    component_missing: handle NaNs per observation component (per-step
        masked innovation systems) instead of degrading whole steps.

    Time-parallel: O(log T) depth via two associative scans — but note the
    O(T log T) *work* and the O(T)-instance combine network in the HLO;
    single-chip, prefer :func:`mv_lgssm_smooth_blocked` (same marginals,
    O(T) work, measured ~2 orders of magnitude faster at bench shapes).
    """
    y = jnp.asarray(y)
    A, Q, H, R = map(jnp.asarray, (A, Q, H, R))
    m0, P0 = map(jnp.asarray, prior)
    elems = _build_filter_elems(
        y, A, Q, H, R, m0, P0, component_missing=component_missing
    )

    filtered = lax.associative_scan(_combine, elems, axis=0)
    fm, fP = filtered.b, filtered.C  # (T, ..., d), (T, ..., d, d)

    selems = _build_smoother_elems(fm, fP, A, Q)
    smoothed = lax.associative_scan(_scombine, selems, axis=0, reverse=True)
    return MvChainMarginals(
        jnp.moveaxis(smoothed.g, 0, -2), jnp.moveaxis(smoothed.L, 0, -3)
    )


def _pick_blocks(T: int) -> int:
    """Largest divisor of T closest to √T (1 for prime T — degenerates to
    the sequential fold, still correct)."""
    target = max(1, int(round(T**0.5)))
    best = 1
    for b in range(1, T + 1):
        if T % b == 0 and abs(b - target) < abs(best - target):
            best = b
    return best


@float32_matmuls
def mv_lgssm_smooth_blocked(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
    *,
    blocks: int = None,
    component_missing: bool = False,
) -> MvChainMarginals:
    """Exact RTS marginals via a two-level blocked scan — the single-device
    form of the time-parallel smoother.

    The flat ``lax.associative_scan`` over T elements performs O(T log T)
    combines as a soup of tiny elementwise ops.  This path applies
    the scheme :func:`cortex_tpu.parallel.mv_lgssm_smooth_time_sharded`
    uses *across* devices within one chip:

    1. split T into B blocks; fold each block's elements into one combined
       element with a sequential ``lax.scan`` batched over the B blocks
       (O(T) work, one combine instance in the HLO),
    2. associative-scan the B block elements (B ≪ T combines),
    3. fill in each block sequentially from its entering belief — the
       forward fill-in is a single d-system solve per step (the A = 0
       specialization of the combine), the backward fill-in is 3 matmuls.

    Identical marginals to :func:`mv_lgssm_smooth` (same algebra, same
    masked-NaN missing-data semantics, incl. ``component_missing=True``
    for per-component gaps); depth 4·T/B + O(log B) — with
    B ≈ √T that is O(√T) vs the sequential smoother's O(T), at ~2× its
    work instead of the flat scan's ~(log T)× with worse constants.
    The reference smooths chains by sequential alternating sweeps
    (``/root/reference/src/inference_engine.jl:575-607``); this is that
    computation restructured for a 2D-parallel machine.
    """
    y = jnp.asarray(y)
    A, Q, H, R = map(jnp.asarray, (A, Q, H, R))
    m0, P0 = map(jnp.asarray, prior)
    d = A.shape[-1]
    T = y.shape[-2]
    B = blocks if blocks is not None else _pick_blocks(T)
    if T % B:
        raise ValueError(f"blocks={B} must divide T={T}")
    Tb = T // B
    batch = y.shape[:-2]
    tree_map = jax.tree_util.tree_map

    # Everything below runs in the lane-major layout (replicas on lanes;
    # see the lane-major algebra section above for the measured 35×).
    elems, _ = _build_filter_elems_lanes(
        y, A, Q, H, R, m0, P0, component_missing=component_missing
    )
    lanes = elems.b.shape[-1]

    def to_blocks(a):  # (T, *r) -> (Tb, B, *r)
        return jnp.moveaxis(a.reshape((B, Tb) + a.shape[1:]), 1, 0)

    def from_blocks(a):  # (Tb, B, *r) -> (T, *r)
        return jnp.moveaxis(a, 0, 1).reshape((B * Tb,) + a.shape[2:])

    eb = tree_map(to_blocks, elems)

    # 1-2. block totals (sequential, batched over B) + cross-block scan.
    ident = _lelem_identity((B,), d, lanes, y.dtype)
    totals = _lseq_filter_total(eb, ident)
    cum = lax.associative_scan(_lcombine, totals, axis=0)
    # Entering belief per block: block k enters with blocks 0..k-1 folded.
    # Block 0 enters with the zero belief — its first element is the
    # prior-conditioned elem1 (A = 0), which overwrites it exactly.
    enter_b = jnp.concatenate([jnp.zeros_like(cum.b[:1]), cum.b[:-1]], axis=0)
    enter_C = jnp.concatenate([jnp.zeros_like(cum.C[:1]), cum.C[:-1]], axis=0)

    # 3. forward fill-in -> filtered moments, reassembled time-major.
    fb, fC = _lfilter_fillin(eb, enter_b, enter_C)
    fm, fP = from_blocks(fb), from_blocks(fC)  # (T, d, L), (T, d, d, L)

    # Backward: same two-level scheme over the RTS affine elements.
    selems = _build_smoother_elems_lanes(fm, fP, A, Q)
    sb = tree_map(to_blocks, selems)
    sident = _lselem_identity((B,), d, lanes, y.dtype)
    stotals = _lseq_smoother_total(sb, sident)
    scum = lax.associative_scan(_lscombine, stotals, axis=0, reverse=True)
    # Exclusive suffix per block (identity for the last block), applied to
    # each block's LAST element = smoothed moments at the block boundary.
    sexcl = tree_map(
        lambda a, i: jnp.concatenate([a[1:], i[:1]], axis=0), scum, sident
    )
    e_last = tree_map(lambda a: a[-1], sb)
    slast = _lscombine(sexcl, e_last)
    ms, Ps = _lsmoother_fillin(sb, slast.g, slast.L)
    mean_t = from_blocks(ms)  # (T, d, L)
    cov_t = from_blocks(Ps)  # (T, d, d, L)
    mean = jnp.moveaxis(mean_t, -1, 0).reshape(batch + (T, d))
    cov = jnp.moveaxis(cov_t, -1, 0).reshape(batch + (T, d, d))
    return MvChainMarginals(mean, cov)


def _mv_filter_scan(y, A, Q, H, R, prior):
    """Shared sequential filter: returns (means, covs, loglik-per-step).

    Sequential `lax.scan` (the associative path above serves smoothing; the
    evidence needs the per-step innovation terms anyway).  Missing data is
    handled PER COMPONENT: a NaN in one observation
    component drops only that component's information — the masked update
    uses ``H' = diag(c) H`` and ``R' = diag(c) R diag(c) + diag(1-c)``
    (the observed submatrix embedded with unit variance on masked rows), so
    the innovation system stays static-shaped, block-diagonal between
    observed and masked components, and SPD; masked components contribute
    exactly zero to the state update and to the log evidence (the constant
    counts observed components only).  A fully-NaN step degenerates to pure
    prediction with zero log-likelihood.  This is the granularity the
    reference gets from per-signal observations
    (``/root/reference/src/signal.jl:232-253``: an unset component's
    message simply never enters the product).
    """
    y = jnp.asarray(y)
    A, Q, H, R = map(lambda a: jnp.asarray(a, y.dtype), (A, Q, H, R))
    m0 = jnp.asarray(prior[0], y.dtype)
    P0 = jnp.asarray(prior[1], y.dtype)
    d = A.shape[-1]
    mdim = H.shape[-2]
    cmask = ~jnp.isnan(y)  # (..., T, m) per-component
    y = jnp.where(cmask, y, 0.0)
    yT = jnp.moveaxis(y, -2, 0)
    cT = jnp.moveaxis(cmask, -2, 0)  # (T, ..., m)
    batch = yT.shape[1:-1]
    eye_m = jnp.eye(mdim, dtype=y.dtype)

    def update(mean, P, obs, cm):
        # One pivotless Gauss-Jordan elimination of the SPD innovation
        # system yields S⁻¹innov, S⁻¹HP, and log det S together — replacing
        # the Cholesky + two triangular-solve custom calls, which run one
        # after another at every step inside lax.scan.
        c = cm.astype(y.dtype)  # (..., m)
        Hm = c[..., :, None] * H  # masked rows zeroed, (..., m, d)
        Rm = c[..., :, None] * c[..., None, :] * R + (1.0 - c)[
            ..., :, None
        ] * eye_m
        S = Hm @ P @ _mT(Hm) + Rm  # (..., m, m)
        innov = obs - jnp.einsum("...md,...d->...m", Hm, mean)
        PHt = P @ _mT(Hm)
        rhs = jnp.concatenate([innov[..., None], _mT(PHt)], axis=-1)
        sol, logdetS = _solve_small_logdet(
            jnp.broadcast_to(S, innov.shape[:-1] + (mdim, mdim)), rhs
        )
        u = sol[..., 0]  # S⁻¹ innov
        SiHP = sol[..., 1:]  # S⁻¹ H P, (..., m, d)
        # Masked components have unit diagonal in S (log det term 0) and
        # zero innovation; the 2π constant counts observed components only.
        ll = (
            -0.5 * jnp.sum(innov * u, axis=-1)
            - 0.5 * logdetS
            - 0.5 * jnp.sum(c, axis=-1) * jnp.log(2.0 * jnp.pi)
        )
        mean_u = mean + jnp.einsum("...dm,...m->...d", PHt, u)
        P_u = P - PHt @ SiHP
        # Rounding in the elimination asymmetrizes P slightly; over long
        # chains that compounds until S loses SPD (NaN evidence gradients at
        # T=200).  Re-symmetrize every step.
        P_u = 0.5 * (P_u + _mT(P_u))
        return mean_u, P_u, ll

    mean0 = jnp.broadcast_to(m0, batch + (d,))
    Pp0 = jnp.broadcast_to(P0, batch + (d, d))
    mean1, P1, ll1 = update(mean0, Pp0, yT[0], cT[0])

    def step(carry, inp):
        obs, cm = inp
        mean, P = carry
        mp = jnp.einsum("ij,...j->...i", A, mean)
        Pp = A @ P @ _mT(A) + Q
        mf, Pf, ll = update(mp, Pp, obs, cm)
        return (mf, Pf), (mf, Pf, ll)

    _, (means, covs, lls) = lax.scan(step, (mean1, P1), (yT[1:], cT[1:]))
    means = jnp.concatenate([mean1[None], means], axis=0)
    covs = jnp.concatenate([P1[None], covs], axis=0)
    lls = jnp.concatenate([ll1[None], lls], axis=0)
    return means, covs, lls


@float32_matmuls
def mv_lgssm_smooth_seq(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> MvChainMarginals:
    """Sequential RTS smoother (filter ``lax.scan`` + backward ``lax.scan``).

    Same marginals as :func:`mv_lgssm_smooth`.  The associative scan
    performs ~2× the combine work of the sequential recursions to buy
    O(log T) *depth*, which only pays when the time axis is sharded across
    devices (``parallel.time_sharded``)."""
    A_, Q_ = jnp.asarray(A), jnp.asarray(Q)
    means, covs, _ = _mv_filter_scan(y, A_, Q_, H, R, prior)
    A_ = jnp.asarray(A_, means.dtype)
    Q_ = jnp.asarray(Q_, means.dtype)

    def back(carry, inp):
        ms_next, Ps_next = carry
        mf, Pf = inp
        Pp = A_ @ Pf @ _mT(A_) + Q_
        G = _mT(_solve_small(_mT(Pp), A_ @ _mT(Pf), pivot=False))
        ms = mf + jnp.einsum(
            "...de,...e->...d", G, ms_next - jnp.einsum("de,...e->...d", A_, mf)
        )
        Ps = Pf + G @ (Ps_next - Pp) @ _mT(G)
        return (ms, Ps), (ms, Ps)

    _, (ms_rest, Ps_rest) = lax.scan(
        back,
        (means[-1], covs[-1]),
        (means[:-1], covs[:-1]),
        reverse=True,
    )
    ms = jnp.concatenate([ms_rest, means[-1:]], axis=0)
    Ps = jnp.concatenate([Ps_rest, covs[-1:]], axis=0)
    return MvChainMarginals(jnp.moveaxis(ms, 0, -2), jnp.moveaxis(Ps, 0, -3))


class MvSmootherOperator(NamedTuple):
    """Precompiled affine smoother: ``means = y·L + c``, covs constant.

    For a time-invariant LGSSM the smoothed means are affine in the stacked
    observations and the smoothed covariances do not depend on the data at
    all — the entire smoothing sweep collapses to ONE ``(R, T·m) @
    (T·m, T·d)`` matmul against a precomputed operator plus a constant
    covariance track.  The d-dimensional generalization of the scalar
    ``lgssm_smooth_matmul`` trick (``ops/chains.py``); O(T²·m·d) FLOPs per
    replica (vs O(T·d³) sequential) — wins while the (T·m, T·d) operator
    fits comfortably, loses at very large T.  Dense data only (no NaNs:
    missingness changes the operator)."""

    L: jax.Array  # (T*m, T*d)
    c: jax.Array  # (T, d) affine offset (prior contribution)
    cov: jax.Array  # (T, d, d) data-independent smoothed covariances


@float32_matmuls
def mv_lgssm_smoother_operator(
    T: int,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> MvSmootherOperator:
    """Build the affine operator by smoothing the T·m unit-impulse inputs
    as one batch (linearity: column k of L is ``smooth(e_k) - smooth(0)``)."""
    A_, Q_, H_, R_ = map(jnp.asarray, (A, Q, H, R))
    m = H_.shape[-2]
    d = A_.shape[-1]
    basis = jnp.concatenate(
        [jnp.zeros((1, T * m)), jnp.eye(T * m)], axis=0
    ).reshape(T * m + 1, T, m)
    out = mv_lgssm_smooth_seq(basis, A_, Q_, H_, R_, prior)
    c = out.mean[0]  # (T, d): response to all-zero observations
    L = (out.mean[1:] - c).reshape(T * m, T * d)
    return MvSmootherOperator(L, c, out.cov[0])


@float32_matmuls
def mv_lgssm_smooth_matmul(
    y: jax.Array,
    A: jax.Array = None,
    Q: jax.Array = None,
    H: jax.Array = None,
    R: jax.Array = None,
    prior: Tuple[jax.Array, jax.Array] = None,
    operator: MvSmootherOperator = None,
) -> MvChainMarginals:
    """Smoothing as one matmul against a precomputed affine operator.

    Identical marginals to :func:`mv_lgssm_smooth` for dense data; pass
    ``operator=`` to amortize the build across sweeps."""
    y = jnp.asarray(y)
    T, m = y.shape[-2], y.shape[-1]
    if operator is None:
        operator = mv_lgssm_smoother_operator(T, A, Q, H, R, prior)
    d = operator.c.shape[-1]
    flat = y.reshape(y.shape[:-2] + (T * m,))
    means = (
        jnp.einsum(
            "...k,kj->...j",
            flat,
            operator.L,
            precision=lax.Precision.HIGHEST,
        ).reshape(y.shape[:-2] + (T, d))
        + operator.c
    )
    cov = jnp.broadcast_to(operator.cov, y.shape[:-2] + (T, d, d))
    return MvChainMarginals(means, cov)


@float32_matmuls
def mv_lgssm_filter(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> MvChainMarginals:
    """Filtered beliefs p(x_t | y_{1:t}) for the vector-state LGSSM
    (streaming posterior).  Same parameter contract as
    :func:`mv_lgssm_smooth`; NaNs are masked per component
    (:func:`_mv_filter_scan`) and fully-NaN steps predict through the
    gap."""
    means, covs, _ = _mv_filter_scan(y, A, Q, H, R, prior)
    return MvChainMarginals(jnp.moveaxis(means, 0, -2), jnp.moveaxis(covs, 0, -3))


@float32_matmuls
def mv_lgssm_log_evidence(
    y: jax.Array,
    A: jax.Array,
    Q: jax.Array,
    H: jax.Array,
    R: jax.Array,
    prior: Tuple[jax.Array, jax.Array],
) -> jax.Array:
    """log p(y_{1:T}) via the prediction-error decomposition, shape
    ``y.shape[:-2]`` (one value per replica).  Differentiable in all
    parameters — the ML system-identification hook for vector models.  NaN
    components are marginalized analytically, per component
    (:func:`_mv_filter_scan`)."""
    _, _, lls = _mv_filter_scan(y, A, Q, H, R, prior)
    return jnp.sum(lls, axis=0)
