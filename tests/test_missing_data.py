"""Missing observations (NaN) across every chain-inference path.

Oracle: the scalar chain's posterior is a Gaussian with tridiagonal
precision, so the exact answer under any missingness pattern comes from
assembling the dense information form (transition blocks + observation
terms for the *observed* steps only) and solving — no filtering code shared
with the implementation under test.  The multivariate/sqrt paths are pinned
against a numpy RTS that skips updates on masked steps.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cortex_tpu.models import LGSSM, MvLGSSM
from cortex_tpu.ops import (
    lgssm_smooth_assoc,
    lgssm_smooth_scan,
    mv_lgssm_smooth,
    sqrt_lgssm_smooth,
)


def _dense_oracle(y, A, Q, H, R, prior=None):
    """Exact posterior via the chain's tridiagonal information form."""
    T = len(y)
    J = np.zeros((T, T))
    h = np.zeros(T)
    for t in range(T):
        if not np.isnan(y[t]):
            J[t, t] += H * H / R
            h[t] += H * y[t] / R
    for t in range(T - 1):
        J[t, t] += A * A / Q
        J[t, t + 1] += -A / Q
        J[t + 1, t] += -A / Q
        J[t + 1, t + 1] += 1.0 / Q
    if prior is not None:
        pm, pv = prior
        J[0, 0] += 1.0 / pv
        h[0] += pm / pv
    cov = np.linalg.inv(J)
    return cov @ h, np.diag(cov)


def _mask(y, idx):
    y = np.array(y, dtype=np.float32)
    y[..., idx] = np.nan
    return y


@pytest.mark.parametrize("method", ["scan", "assoc"])
@pytest.mark.parametrize("use_prior", [False, True])
def test_scalar_smoothing_matches_dense_oracle_with_gaps(method, use_prior):
    rng = np.random.default_rng(0)
    T = 25
    y = rng.normal(size=T).cumsum().astype(np.float32)
    y = _mask(y, [3, 4, 5, 11, 17, 18, 23])  # interior runs + isolated gaps
    A, Q, H, R = 0.9, 0.5, 1.2, 0.8
    prior = (0.3, 2.0) if use_prior else None
    model = LGSSM(A=A, Q=Q, H=H, R=R)
    out = model.smooth(jnp.asarray(y), prior=prior, method=method)
    mean_o, var_o = _dense_oracle(y, A, Q, H, R, prior)
    np.testing.assert_allclose(out.mean, mean_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out.variance, var_o, rtol=2e-3, atol=2e-3)


def test_scalar_missing_first_observation_with_prior():
    rng = np.random.default_rng(1)
    y = _mask(rng.normal(size=12).astype(np.float32), [0, 1])
    A, Q, H, R = 1.0, 1.0, 1.0, 1.0
    prior = (0.0, 5.0)
    for method in ("scan", "assoc"):
        out = LGSSM(A=A, Q=Q, H=H, R=R).smooth(jnp.asarray(y), prior=prior, method=method)
        mean_o, var_o = _dense_oracle(y, A, Q, H, R, prior)
        np.testing.assert_allclose(out.mean, mean_o, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(out.variance, var_o, rtol=2e-3, atol=2e-3)


def test_missing_steps_have_inflated_variance():
    rng = np.random.default_rng(2)
    y = rng.normal(size=(7, 30)).cumsum(axis=-1).astype(np.float32)
    y[:, 14] = np.nan
    out = LGSSM(A=1.0, Q=0.3, H=1.0, R=0.4).smooth(jnp.asarray(y), prior=(0.0, 10.0))
    assert bool(jnp.all(out.variance[:, 14] > out.variance[:, 13]))
    assert bool(jnp.all(out.variance[:, 14] > out.variance[:, 15]))
    assert bool(jnp.all(jnp.isfinite(out.mean)))


def test_filter_predicts_through_gaps():
    y = np.zeros(10, np.float32)
    y[5:] = np.nan
    model = LGSSM(A=0.9, Q=0.2, H=1.0, R=0.5)
    out = model.filter(jnp.asarray(y), prior=(0.0, 1.0))
    # After observations stop, variance grows monotonically toward the
    # stationary prior and the mean decays geometrically.
    v = np.asarray(out.variance)
    assert np.all(np.diff(v[5:]) > 0) or np.allclose(np.diff(v[5:]), 0, atol=1e-6)
    m = np.asarray(out.mean)
    np.testing.assert_allclose(m[6:], m[5] * 0.9 ** np.arange(1, 5), rtol=1e-4, atol=1e-5)


def test_log_evidence_marginalizes_missing():
    """Evidence with a NaN step must equal the evidence of the model where
    that observation is analytically marginalized (numpy PE decomposition
    skipping the update)."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=20).cumsum().astype(np.float32)
    ymask = _mask(y, [4, 5, 13])
    A, Q, H, R = 0.95, 0.4, 1.0, 0.6
    le = float(LGSSM(A=A, Q=Q, H=H, R=R).log_evidence(jnp.asarray(ymask), prior=(0.0, 1.0)))

    m, v = 0.0, 1.0
    ll = 0.0
    for t in range(20):
        if not np.isnan(ymask[t]):
            s = H * H * v + R
            ll += -0.5 * (np.log(2 * np.pi * s) + (ymask[t] - H * m) ** 2 / s)
            g = v * H / s
            m = m + g * (ymask[t] - H * m)
            v = v - g * H * v
        m, v = A * m, A * A * v + Q
    np.testing.assert_allclose(le, ll, rtol=1e-4)


def _np_masked_rts(y, mask, A, Q, H, R, m0, P0):
    T = y.shape[0]
    d = A.shape[0]
    fm = np.zeros((T, d))
    fP = np.zeros((T, d, d))
    mean, P = m0.copy(), P0.copy()
    for t in range(T):
        if t > 0:
            mean = A @ mean
            P = A @ P @ A.T + Q
        if mask[t]:
            S = H @ P @ H.T + R
            K = P @ H.T @ np.linalg.inv(S)
            mean = mean + K @ (y[t] - H @ mean)
            P = P - K @ S @ K.T
        fm[t], fP[t] = mean, P
    sm, sP = fm.copy(), fP.copy()
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.T + Q
        G = fP[t] @ A.T @ np.linalg.inv(Pp)
        sm[t] = fm[t] + G @ (sm[t + 1] - A @ fm[t])
        sP[t] = fP[t] + G @ (sP[t + 1] - Pp) @ G.T
    return sm, sP


def test_mv_and_sqrt_smoothing_match_masked_rts_oracle():
    rng = np.random.default_rng(4)
    d, m, T = 3, 2, 30
    A = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    Q = 0.3 * np.eye(d)
    H = rng.normal(size=(m, d))
    R = 0.5 * np.eye(m)
    m0, P0 = np.zeros(d), np.eye(d)
    y = rng.normal(size=(T, m)).astype(np.float32)
    missing = [0, 6, 7, 8, 21, 29]
    y[missing] = np.nan
    mask = np.ones(T, bool)
    mask[missing] = False

    sm, sP = _np_masked_rts(np.nan_to_num(y.astype(np.float64)), mask, A, Q, H, R, m0, P0)
    fast = mv_lgssm_smooth(jnp.asarray(y), A, Q, H, R, (m0, P0))
    np.testing.assert_allclose(fast.mean, sm, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(fast.cov, sP, rtol=5e-3, atol=2e-3)

    robust = sqrt_lgssm_smooth(jnp.asarray(y), A, Q, H, R, (m0, P0))
    np.testing.assert_allclose(robust.mean, sm, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(robust.cov, sP, rtol=5e-3, atol=2e-3)


def test_mv_batched_mixed_missingness_patterns():
    """Different replicas missing different steps — the vectorized mask must
    not leak across the batch."""
    rng = np.random.default_rng(5)
    d = 2
    A = np.array([[0.9, 0.1], [0.0, 0.8]])
    Q = 0.2 * np.eye(d)
    H = np.eye(d)
    R = 0.3 * np.eye(d)
    m0, P0 = np.zeros(d), np.eye(d)
    T = 15
    y = rng.normal(size=(2, T, d)).astype(np.float32)
    y[0, 3:6] = np.nan
    y[1, 10] = np.nan
    out = mv_lgssm_smooth(jnp.asarray(y), A, Q, H, R, (m0, P0))
    for b in range(2):
        mask = ~np.isnan(y[b, :, 0])
        sm, sP = _np_masked_rts(
            np.nan_to_num(y[b].astype(np.float64)), mask, A, Q, H, R, m0, P0
        )
        np.testing.assert_allclose(out.mean[b], sm, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(out.cov[b], sP, rtol=5e-3, atol=2e-3)


def test_hmm_missing_observations_marginalize():
    """obs = -1 encodes a missing step: its one-hot row is all-zero, which is
    exactly the uniform-likelihood marginalization.  Evidence and marginals
    must match forward-backward on a hand-built log_lik with a zero row."""
    import jax

    from cortex_tpu.models import HMM
    from cortex_tpu.ops import hmm_forward_backward

    K, M, T = 3, 4, 20
    rng = np.random.default_rng(6)
    A = rng.dirichlet(np.ones(K) * 3, size=K)
    B = rng.dirichlet(np.ones(M) * 2, size=K)
    pi = np.full(K, 1.0 / K)
    obs = rng.integers(0, M, size=T)
    obs[[4, 5, 12]] = -1

    log_B = jnp.log(jnp.asarray(B, jnp.float32))
    onehot = jax.nn.one_hot(jnp.asarray(obs), M)
    log_lik_auto = jnp.einsum("tm,km->tk", onehot, log_B)
    log_lik_manual = np.log(B[:, obs.clip(0)].T).astype(np.float32)
    log_lik_manual[obs < 0] = 0.0
    np.testing.assert_allclose(log_lik_auto, log_lik_manual, atol=1e-6)

    post = hmm_forward_backward(
        jnp.asarray(log_lik_manual),
        jnp.log(jnp.asarray(A, jnp.float32)),
        jnp.log(jnp.asarray(pi, jnp.float32)),
    )
    # Missing steps: marginals are proper distributions driven by neighbors.
    gam = np.exp(np.asarray(post.log_gamma))
    np.testing.assert_allclose(gam.sum(-1), 1.0, rtol=1e-5)
    # Evidence equals the sum over the missing symbol of full-data evidences
    # (checked by brute force over one missing slot).
    obs_single = rng.integers(0, M, size=8)
    obs_single[3] = -1
    oh = jax.nn.one_hot(jnp.asarray(obs_single), M)
    ll = jnp.einsum("tm,km->tk", oh, log_B)
    le_missing = float(
        hmm_forward_backward(
            ll, jnp.log(jnp.asarray(A, jnp.float32)), jnp.log(jnp.asarray(pi, jnp.float32))
        ).log_evidence
    )
    evs = []
    for sym in range(M):
        o = obs_single.copy()
        o[3] = sym
        oh2 = jax.nn.one_hot(jnp.asarray(o), M)
        ll2 = jnp.einsum("tm,km->tk", oh2, log_B)
        evs.append(
            float(
                hmm_forward_backward(
                    ll2,
                    jnp.log(jnp.asarray(A, jnp.float32)),
                    jnp.log(jnp.asarray(pi, jnp.float32)),
                ).log_evidence
            )
        )
    np.testing.assert_allclose(le_missing, np.log(np.sum(np.exp(evs))), rtol=1e-5)


def test_hmm_fit_vmp_tolerates_missing():
    from cortex_tpu.models import HMM

    rng = np.random.default_rng(7)
    obs = rng.integers(0, 3, size=(4, 40))
    obs[:, 10:13] = -1
    hmm = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))
    result = hmm.fit_vmp(jnp.asarray(obs), n_symbols=3, n_iterations=10)
    assert np.isfinite(float(jnp.sum(result.posterior.log_evidence)))
    gam = np.exp(np.asarray(result.posterior.log_gamma))
    np.testing.assert_allclose(gam.sum(-1), 1.0, rtol=1e-4)


# ---------------------------------------------------------------------------
# Per-component missingness: dense float64
# information-form oracle — no filtering code shared with the paths under
# test.  A NaN in ONE component must keep the other components' information.
# ---------------------------------------------------------------------------


def _mv_info_oracle(y, A, Q, H, R, m0, P0):
    """Exact smoothed marginals under arbitrary per-component missingness:
    assemble the joint precision/potential over the stacked states x_{1:T}
    (prior + transitions + H_oᵀR_oo⁻¹H_o observation terms for the OBSERVED
    component subsets only) and solve, in float64."""
    T = y.shape[0]
    d = A.shape[0]
    inv = np.linalg.inv
    J = np.zeros((T * d, T * d))
    h = np.zeros(T * d)
    iP0 = inv(P0)
    J[:d, :d] += iP0
    h[:d] += iP0 @ m0
    iQ = inv(Q)
    for t in range(T - 1):
        s, e, e2 = t * d, (t + 1) * d, (t + 2) * d
        J[s:e, s:e] += A.T @ iQ @ A
        J[s:e, e:e2] += -A.T @ iQ
        J[e:e2, s:e] += -iQ @ A
        J[e:e2, e:e2] += iQ
    for t in range(T):
        o = ~np.isnan(y[t])
        if o.any():
            Ho = H[o]
            iR = inv(R[np.ix_(o, o)])
            s, e = t * d, (t + 1) * d
            J[s:e, s:e] += Ho.T @ iR @ Ho
            h[s:e] += Ho.T @ iR @ y[t][o]
    Sig = inv(J)
    mean = (Sig @ h).reshape(T, d)
    covs = np.stack([Sig[t * d : (t + 1) * d, t * d : (t + 1) * d] for t in range(T)])
    return mean, covs


def _component_pattern(rng, T, m):
    """Mixed pattern: dense steps, partial steps (1..m-1 comps NaN), one
    fully-missing step."""
    y = rng.normal(size=(T, m)).cumsum(0).astype(np.float32)
    y[2, 0] = np.nan
    y[5, 1:] = np.nan
    y[7] = np.nan  # fully missing
    y[9, m - 1] = np.nan
    return y


@pytest.mark.parametrize("method", ["scan", "blocked", "assoc"])
def test_mv_component_missing_matches_info_oracle(method):
    from cortex_tpu.models import MvLGSSM as _Mv

    rng = np.random.default_rng(11)
    d = m = 3
    T = 12
    A = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    Q = 0.3 * np.eye(d) + 0.05
    H = rng.normal(size=(m, d))
    C = rng.normal(size=(m, m))
    R = 0.4 * np.eye(m) + 0.1 * (C @ C.T)  # correlated noise: masking R⁻¹
    # rows would be WRONG; the paths must use the observed submatrix
    m0, P0 = 0.1 * np.ones(d), np.eye(d)
    y = _component_pattern(rng, T, m)
    model = _Mv.from_arrays(A=A, Q=Q, H=H, R=R, m0=m0, P0=P0)
    out = model.smooth(jnp.asarray(y), method=method)  # missing="auto"
    mean_o, cov_o = _mv_info_oracle(y.astype(np.float64), A, Q, H, R, m0, P0)
    np.testing.assert_allclose(out.mean, mean_o, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out.cov, cov_o, rtol=5e-3, atol=2e-3)


def test_mv_component_missing_batched_blocked():
    """Replica 0 dense, replica 1 partial, replica 2 step-missing — the
    lane-major component builder must keep patterns separate."""
    from cortex_tpu.ops.chains_mv import mv_lgssm_smooth_blocked

    rng = np.random.default_rng(12)
    d = m = 2
    T = 16
    A = np.array([[0.9, 0.1], [0.0, 0.85]])
    Q = 0.25 * np.eye(d)
    H = np.array([[1.0, 0.0], [0.3, 1.0]])
    R = np.array([[0.5, 0.15], [0.15, 0.4]])
    m0, P0 = np.zeros(d), np.eye(d)
    y = rng.normal(size=(3, T, m)).cumsum(1).astype(np.float32)
    y[1, 4, 0] = np.nan
    y[1, 9, 1] = np.nan
    y[2, 6:8] = np.nan
    out = mv_lgssm_smooth_blocked(
        jnp.asarray(y), A, Q, H, R, (m0, P0), component_missing=True
    )
    for b in range(3):
        mean_o, cov_o = _mv_info_oracle(
            y[b].astype(np.float64), A, Q, H, R, m0, P0
        )
        np.testing.assert_allclose(out.mean[b], mean_o, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(out.cov[b], cov_o, rtol=5e-3, atol=2e-3)


def test_mv_filter_and_evidence_per_component():
    """Filter/log_evidence mask per component: evidence must equal the
    log-density of the OBSERVED components under their joint Gaussian
    (computed from the prior-propagated moments in numpy, float64)."""
    from cortex_tpu.models import MvLGSSM as _Mv

    rng = np.random.default_rng(13)
    d = m = 2
    T = 10
    A = np.array([[0.8, 0.2], [0.0, 0.9]])
    Q = 0.3 * np.eye(d)
    H = np.array([[1.0, 0.2], [0.0, 1.0]])
    R = np.array([[0.4, 0.1], [0.1, 0.5]])
    m0, P0 = np.array([0.2, -0.1]), 0.8 * np.eye(d)
    y = _component_pattern(rng, T, m)
    model = _Mv.from_arrays(A=A, Q=Q, H=H, R=R, m0=m0, P0=P0)
    le = float(model.log_evidence(jnp.asarray(y)))

    # Joint Gaussian of all T*m observation entries.
    mu_x = np.zeros((T, d))
    Pmarg = np.zeros((T, d, d))
    mu_x[0], Pmarg[0] = m0, P0
    for t in range(1, T):
        mu_x[t] = A @ mu_x[t - 1]
        Pmarg[t] = A @ Pmarg[t - 1] @ A.T + Q
    cov_y = np.zeros((T, m, T, m))
    mu_y = np.zeros((T, m))
    for t in range(T):
        mu_y[t] = H @ mu_x[t]
        for s in range(T):
            if s <= t:
                Cxx = np.linalg.matrix_power(A, t - s) @ Pmarg[s]
            else:
                Cxx = (np.linalg.matrix_power(A, s - t) @ Pmarg[t]).T
            cov_y[t, :, s, :] = H @ Cxx @ H.T + (R if s == t else 0.0)
    obs = ~np.isnan(y.reshape(-1))
    mu_o = mu_y.reshape(-1)[obs]
    cov_o = cov_y.reshape(T * m, T * m)[np.ix_(obs, obs)]
    resid = y.reshape(-1)[obs].astype(np.float64) - mu_o
    sign, logdet = np.linalg.slogdet(cov_o)
    ll = -0.5 * (
        resid @ np.linalg.solve(cov_o, resid)
        + logdet
        + obs.sum() * np.log(2 * np.pi)
    )
    np.testing.assert_allclose(le, ll, rtol=1e-4)

    # The filter keeps observed-component information on partial steps:
    # variance at t=2 (component 0 missing, component 1 seen) must be
    # strictly tighter than predicting through a fully-missing step.
    out = model.filter(jnp.asarray(y))
    y_gap = y.copy()
    y_gap[2] = np.nan
    out_gap = model.filter(jnp.asarray(y_gap))
    assert float(out.cov[2, 1, 1]) < float(out_gap.cov[2, 1, 1]) - 1e-4


def test_mv_smooth_auto_missing_detection():
    """Default missing='auto' upgrades to the component path on concrete
    partially-observed input (step-masking the same data is measurably
    different), and matmul/sqrt refuse component gaps."""
    from cortex_tpu.models import MvLGSSM as _Mv

    rng = np.random.default_rng(14)
    d = m = 2
    T = 8
    A, Q = 0.9 * np.eye(d), 0.3 * np.eye(d)
    H, R = np.eye(m), 0.4 * np.eye(m)
    m0, P0 = np.zeros(d), np.eye(d)
    y = rng.normal(size=(T, m)).cumsum(0).astype(np.float32)
    y[3, 0] = np.nan
    model = _Mv.from_arrays(A=A, Q=Q, H=H, R=R, m0=m0, P0=P0)
    auto = model.smooth(jnp.asarray(y), method="blocked")
    comp = model.smooth(jnp.asarray(y), method="blocked", missing="component")
    step = model.smooth(jnp.asarray(y), method="blocked", missing="step")
    np.testing.assert_allclose(auto.mean, comp.mean, rtol=1e-6)
    assert abs(float(step.cov[3, 1, 1]) - float(comp.cov[3, 1, 1])) > 1e-4
    mean_o, cov_o = _mv_info_oracle(y.astype(np.float64), A, Q, H, R, m0, P0)
    np.testing.assert_allclose(comp.mean, mean_o, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="matmul"):
        model.smooth(jnp.asarray(y), method="matmul")
    with pytest.raises(ValueError, match="sqrt"):
        model.smooth(jnp.asarray(y), method="sqrt")
