"""Vector-state LGSSM tests vs a dense NumPy Kalman/RTS oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from cortex_tpu.ops.chains_mv import mv_lgssm_smooth


def numpy_rts_mv(y, A, Q, H, R, m0, P0):
    T = y.shape[0]
    d = A.shape[0]
    fm = np.zeros((T, d))
    fP = np.zeros((T, d, d))
    m, P = m0, P0
    for t in range(T):
        if t > 0:
            m, P = A @ m, A @ P @ A.T + Q
        S = H @ P @ H.T + R
        K = P @ H.T @ np.linalg.inv(S)
        m = m + K @ (y[t] - H @ m)
        P = P - K @ H @ P
        fm[t], fP[t] = m, P
    sm = np.zeros_like(fm)
    sP = np.zeros_like(fP)
    sm[-1], sP[-1] = fm[-1], fP[-1]
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.T + Q
        G = fP[t] @ A.T @ np.linalg.inv(Pp)
        sm[t] = fm[t] + G @ (sm[t + 1] - A @ fm[t])
        sP[t] = fP[t] + G @ (sP[t + 1] - Pp) @ G.T
    return sm, sP


def _random_system(rng, d, m):
    A = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    Lq = rng.normal(size=(d, d)) * 0.3
    Q = Lq @ Lq.T + 0.1 * np.eye(d)
    H = rng.normal(size=(m, d))
    Lr = rng.normal(size=(m, m)) * 0.3
    R = Lr @ Lr.T + 0.2 * np.eye(m)
    m0 = rng.normal(size=d)
    P0 = np.eye(d) * 2.0
    return A, Q, H, R, m0, P0


@pytest.mark.parametrize("d,m", [(2, 1), (3, 2), (4, 4)])
def test_mv_smoother_matches_numpy_rts(d, m):
    rng = np.random.default_rng(0)
    T = 30
    A, Q, H, R, m0, P0 = _random_system(rng, d, m)
    y = rng.normal(size=(T, m)).astype(np.float64)

    result = mv_lgssm_smooth(
        jnp.asarray(y),
        jnp.asarray(A),
        jnp.asarray(Q),
        jnp.asarray(H),
        jnp.asarray(R),
        (jnp.asarray(m0), jnp.asarray(P0)),
    )
    sm, sP = numpy_rts_mv(y, A, Q, H, R, m0, P0)
    np.testing.assert_allclose(np.asarray(result.mean), sm, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(result.cov), sP, rtol=5e-3, atol=5e-3)


def test_mv_smoother_batched_replicas():
    rng = np.random.default_rng(1)
    d, m, T, B = 2, 1, 20, 6
    A, Q, H, R, m0, P0 = _random_system(rng, d, m)
    ys = rng.normal(size=(B, T, m))

    result = mv_lgssm_smooth(
        jnp.asarray(ys),
        jnp.asarray(A),
        jnp.asarray(Q),
        jnp.asarray(H),
        jnp.asarray(R),
        (jnp.asarray(m0), jnp.asarray(P0)),
    )
    assert result.mean.shape == (B, T, d)
    assert result.cov.shape == (B, T, d, d)
    for b in [0, 3]:
        sm, sP = numpy_rts_mv(ys[b], A, Q, H, R, m0, P0)
        np.testing.assert_allclose(
            np.asarray(result.mean[b]), sm, rtol=5e-3, atol=5e-3
        )


def test_mv_reduces_to_scalar_case():
    from cortex_tpu.ops import lgssm_smooth_scan

    rng = np.random.default_rng(2)
    T = 25
    y = rng.normal(size=T).cumsum()
    result = mv_lgssm_smooth(
        jnp.asarray(y[:, None]),
        jnp.asarray([[0.9]]),
        jnp.asarray([[0.5]]),
        jnp.asarray([[1.0]]),
        jnp.asarray([[1.2]]),
        (jnp.asarray([0.0]), jnp.asarray([[3.0]])),
    )
    scalar = lgssm_smooth_scan(
        jnp.asarray(y), A=0.9, Q=0.5, H=1.0, R=1.2, prior=(0.0, 3.0)
    )
    np.testing.assert_allclose(
        np.asarray(result.mean[:, 0]), np.asarray(scalar.mean), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(result.cov[:, 0, 0]),
        np.asarray(scalar.variance),
        rtol=1e-3,
        atol=1e-3,
    )


def test_mv_lgssm_model_wrapper():
    """MvLGSSM model: sample + smooth round trip reduces observation error."""
    import jax
    from cortex_tpu.models import MvLGSSM

    m = MvLGSSM.from_arrays(
        A=0.9 * np.eye(2),
        Q=0.2 * np.eye(2),
        H=np.array([[1.0, 0.0]]),
        R=[[0.5]],
        m0=[0.0, 0.0],
        P0=np.eye(2),
    )
    x, y = m.sample(jax.random.PRNGKey(0), T=40, batch_shape=(3,))
    assert x.shape == (3, 40, 2) and y.shape == (3, 40, 1)
    marg = m.smooth(y)
    assert marg.mean.shape == (3, 40, 2)
    err = float(jnp.abs(marg.mean[..., 0] - x[..., 0]).mean())
    raw = float(jnp.abs(y[..., 0] - x[..., 0]).mean())
    assert err < raw


def test_solve_small_matches_numpy_lu():
    """The unrolled Gauss-Jordan solve (replacement for the LU
    custom call, ops/chains_mv.py::_solve_small) must match numpy on batched
    systems, including matrices whose naive pivot is zero (forces the
    partial-pivoting row swaps)."""
    import numpy as np
    import jax.numpy as jnp

    from cortex_tpu.ops.chains_mv import _solve_small

    rng = np.random.default_rng(0)
    for d in (1, 2, 4, 7, 16):
        M = rng.normal(size=(5, 3, d, d)).astype(np.float64)
        B = rng.normal(size=(5, 3, d, d + 2)).astype(np.float64)
        got = np.asarray(_solve_small(jnp.asarray(M), jnp.asarray(B)))
        want = np.linalg.solve(M, B)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    # Zero leading pivot: [[0, 1], [1, 0]] breaks pivotless elimination.
    M = np.array([[[0.0, 1.0], [1.0, 2.0]]])
    B = np.array([[[1.0], [0.0]]])
    got = np.asarray(_solve_small(jnp.asarray(M), jnp.asarray(B)))
    np.testing.assert_allclose(got, np.linalg.solve(M, B), atol=1e-6)


def test_mv_matmul_operator_matches_scan():
    """The affine-operator smoother (one (R,Tm)x(Tm,Td) matmul + constant
    covariances, ops/chains_mv.py::mv_lgssm_smooth_matmul) must reproduce
    the sequential RTS path exactly, including a nonzero prior mean (the
    affine offset column)."""
    import numpy as np
    import jax.numpy as jnp

    from cortex_tpu.models import MvLGSSM

    d = 3
    rng = np.random.default_rng(5)
    m = MvLGSSM.from_arrays(
        A=0.8 * np.eye(d) + 0.05 * rng.normal(size=(d, d)),
        Q=np.eye(d) * 0.5,
        H=rng.normal(size=(2, d)),
        R=np.eye(2) * 0.7,
        m0=rng.normal(size=d),
        P0=np.eye(d),
    )
    y = jnp.asarray(rng.normal(size=(5, 24, 2)), jnp.float32)
    a = m.smooth(y, method="scan")
    b = m.smooth(y, method="matmul")
    np.testing.assert_allclose(np.asarray(a.mean), np.asarray(b.mean), atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.cov), np.asarray(b.cov), atol=2e-5)


# ---------------------------------------------------------------------------
# Blocked two-level scan (mv_lgssm_smooth_blocked) — the single-chip form of
# the time-sharded scheme.


@pytest.mark.parametrize("d,m", [(2, 1), (3, 2), (4, 4)])
def test_blocked_matches_numpy_rts(d, m):
    from cortex_tpu.ops.chains_mv import mv_lgssm_smooth_blocked

    rng = np.random.default_rng(3)
    T = 30
    A, Q, H, R, m0, P0 = _random_system(rng, d, m)
    y = rng.normal(size=(T, m)).astype(np.float64)
    sm, sP = numpy_rts_mv(y, A, Q, H, R, m0, P0)
    result = mv_lgssm_smooth_blocked(
        jnp.asarray(y),
        jnp.asarray(A),
        jnp.asarray(Q),
        jnp.asarray(H),
        jnp.asarray(R),
        (jnp.asarray(m0), jnp.asarray(P0)),
    )
    np.testing.assert_allclose(np.asarray(result.mean), sm, atol=1e-6)
    np.testing.assert_allclose(np.asarray(result.cov), sP, atol=1e-6)


@pytest.mark.parametrize("blocks", [1, 2, 5, 10, None])
def test_blocked_block_count_invariance(blocks):
    """Marginals must not depend on the block split (incl. degenerate B=1)."""
    from cortex_tpu.ops.chains_mv import (
        mv_lgssm_smooth_blocked,
        mv_lgssm_smooth_seq,
    )

    rng = np.random.default_rng(4)
    d, m, T = 3, 2, 40
    A, Q, H, R, m0, P0 = _random_system(rng, d, m)
    y = rng.normal(size=(6, T, m)).astype(np.float32)
    y[2, 7, :] = np.nan  # missing step mid-chain
    y[4, 0, :] = np.nan  # missing FIRST step (prior-only first element)
    args = (
        jnp.asarray(y),
        jnp.asarray(A, jnp.float32),
        jnp.asarray(Q, jnp.float32),
        jnp.asarray(H, jnp.float32),
        jnp.asarray(R, jnp.float32),
        (jnp.asarray(m0, jnp.float32), jnp.asarray(P0, jnp.float32)),
    )
    ref = mv_lgssm_smooth_seq(*args)
    out = mv_lgssm_smooth_blocked(*args, blocks=blocks)
    np.testing.assert_allclose(np.asarray(out.mean), np.asarray(ref.mean), atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=2e-4)


def test_blocked_rejects_non_divisor():
    from cortex_tpu.ops.chains_mv import mv_lgssm_smooth_blocked

    y = jnp.zeros((10, 1))
    eye = jnp.eye(1)
    with pytest.raises(ValueError, match="divide"):
        mv_lgssm_smooth_blocked(
            y, eye, eye, eye, eye, (jnp.zeros(1), eye), blocks=3
        )


def test_pick_blocks_near_sqrt():
    from cortex_tpu.ops.chains_mv import _pick_blocks

    assert _pick_blocks(100) == 10
    assert _pick_blocks(256) == 16
    assert _pick_blocks(7) == 1  # prime: degenerates to the sequential fold
    assert _pick_blocks(1) == 1


def test_model_blocked_method_dispatch():
    from cortex_tpu.models import MvLGSSM

    rng = np.random.default_rng(5)
    d = 2
    model = MvLGSSM.from_arrays(
        0.8 * np.eye(d), np.eye(d), np.eye(d), np.eye(d), np.zeros(d), np.eye(d)
    )
    y = jnp.asarray(rng.normal(size=(3, 20, d)), jnp.float32)
    ref = model.smooth(y, method="scan")
    out = model.smooth(y, method="blocked")
    np.testing.assert_allclose(np.asarray(out.mean), np.asarray(ref.mean), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.cov), np.asarray(ref.cov), atol=1e-4)


def test_lane_major_algebra_matches_reference_layout():
    """The lane-major combines (leaves (..., d, d, R)) must stay in exact
    lockstep with the (..., d, d)-minor reference algebra — they are two
    layouts of the same Särkkä elements (the lane-major one is the hot
    path)."""
    from cortex_tpu.ops.chains_mv import (
        _combine,
        _Elem,
        _lcombine,
        _lscombine,
        _scombine,
        _SElem,
    )

    rng = np.random.default_rng(11)
    d, R = 3, 5

    def rand_elem():
        A = rng.normal(size=(R, d, d)) * 0.4 + np.eye(d)
        b = rng.normal(size=(R, d))
        C_ = rng.normal(size=(R, d, d)) * 0.3
        C = C_ @ np.swapaxes(C_, -1, -2) + 0.5 * np.eye(d)
        eta = rng.normal(size=(R, d))
        J_ = rng.normal(size=(R, d, d)) * 0.2
        J = J_ @ np.swapaxes(J_, -1, -2) + 0.1 * np.eye(d)
        return A, b, C, eta, J

    def to_dd(t):
        return _Elem(*[jnp.asarray(x, jnp.float32) for x in t])

    def to_lanes(t):
        # (R, ...) -> (..., R): move the replica axis onto lanes.
        return _Elem(*[jnp.moveaxis(jnp.asarray(x, jnp.float32), 0, -1) for x in t])

    e1, e2 = rand_elem(), rand_elem()
    ref = _combine(to_dd(e1), to_dd(e2))
    lan = _lcombine(to_lanes(e1), to_lanes(e2))
    for f in _Elem._fields:
        np.testing.assert_allclose(
            np.moveaxis(np.asarray(getattr(lan, f)), -1, 0),
            np.asarray(getattr(ref, f)),
            atol=1e-4,
            err_msg=f,
        )

    def rand_selem():
        E = rng.normal(size=(R, d, d)) * 0.5
        g = rng.normal(size=(R, d))
        L_ = rng.normal(size=(R, d, d)) * 0.3
        L = L_ @ np.swapaxes(L_, -1, -2)
        return E, g, L

    s1, s2 = rand_selem(), rand_selem()
    sref = _scombine(
        _SElem(*[jnp.asarray(x, jnp.float32) for x in s1]),
        _SElem(*[jnp.asarray(x, jnp.float32) for x in s2]),
    )
    slan = _lscombine(
        _SElem(*[jnp.moveaxis(jnp.asarray(x, jnp.float32), 0, -1) for x in s1]),
        _SElem(*[jnp.moveaxis(jnp.asarray(x, jnp.float32), 0, -1) for x in s2]),
    )
    for f in _SElem._fields:
        np.testing.assert_allclose(
            np.moveaxis(np.asarray(getattr(slan, f)), -1, 0),
            np.asarray(getattr(sref, f)),
            atol=1e-5,
            err_msg=f,
        )


def test_mv_paths_fuzz_equivalence():
    """Randomized cross-path fuzz: blocked and assoc must match the
    sequential scan over random shapes, block splits, NaN missingness
    patterns, and degenerate chain lengths (T=1 previously crashed the
    smoother-element builders: the terminal element was built from an
    empty gain slice)."""
    from cortex_tpu.ops.chains_mv import (
        mv_lgssm_smooth,
        mv_lgssm_smooth_blocked,
        mv_lgssm_smooth_seq,
    )

    rng = np.random.default_rng(99)
    for trial in range(12):
        d = int(rng.integers(1, 4))
        mdim = int(rng.integers(1, d + 1))
        T = int(rng.choice([1, 2, 3, 5, 8, 12, 24]))
        R = int(rng.integers(1, 4))
        A, Q, H, R_, m0, P0 = _random_system(rng, d, mdim)
        y = rng.normal(size=(R, T, mdim)).astype(np.float32)
        if T > 2 and trial % 2:
            # random missing steps (never all of them)
            n_miss = int(rng.integers(1, T // 2 + 1))
            for idx in rng.choice(T, size=n_miss, replace=False):
                y[rng.integers(0, R), idx, :] = np.nan
        args = (
            jnp.asarray(y),
            jnp.asarray(A, jnp.float32),
            jnp.asarray(Q, jnp.float32),
            jnp.asarray(H, jnp.float32),
            jnp.asarray(R_, jnp.float32),
            (jnp.asarray(m0, jnp.float32), jnp.asarray(P0, jnp.float32)),
        )
        ref = mv_lgssm_smooth_seq(*args)
        for f in (mv_lgssm_smooth_blocked, mv_lgssm_smooth):
            out = f(*args)
            np.testing.assert_allclose(
                np.asarray(out.mean),
                np.asarray(ref.mean),
                atol=5e-4,
                err_msg=f"{f.__name__} trial {trial} d={d} m={mdim} T={T}",
            )
            np.testing.assert_allclose(
                np.asarray(out.cov), np.asarray(ref.cov), atol=5e-4
            )
