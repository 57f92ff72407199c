"""HMM tests: forward-backward vs brute-force enumeration; Dirichlet VMP
recovery; Viterbi; batching."""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cortex_tpu.models import HMM
from cortex_tpu.ops.hmm import hmm_forward_backward, hmm_viterbi


def brute_force_posterior(log_lik, log_A, log_pi):
    """Enumerate all K^T paths (float64)."""
    T, K = log_lik.shape
    gamma = np.zeros((T, K))
    xi_sum = np.zeros((K, K))
    logps = []
    paths = list(itertools.product(range(K), repeat=T))
    for path in paths:
        lp = log_pi[path[0]] + log_lik[0, path[0]]
        for t in range(1, T):
            lp += log_A[path[t - 1], path[t]] + log_lik[t, path[t]]
        logps.append(lp)
    logps = np.array(logps)
    logZ = np.logaddexp.reduce(logps)
    probs = np.exp(logps - logZ)
    for path, pr in zip(paths, probs):
        for t, k in enumerate(path):
            gamma[t, k] += pr
        for t in range(T - 1):
            xi_sum[path[t], path[t + 1]] += pr
    return gamma, xi_sum, logZ


def test_forward_backward_matches_enumeration():
    rng = np.random.default_rng(0)
    T, K = 6, 3
    log_lik = rng.normal(size=(T, K))
    A = rng.random((K, K)) + 0.1
    A /= A.sum(axis=1, keepdims=True)
    pi = rng.random(K) + 0.1
    pi /= pi.sum()

    post = hmm_forward_backward(
        jnp.asarray(log_lik), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )
    gamma_bf, xi_bf, logZ_bf = brute_force_posterior(log_lik, np.log(A), np.log(pi))

    np.testing.assert_allclose(
        np.exp(np.asarray(post.log_gamma)), gamma_bf, rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(post.log_xi_sum)), xi_bf, rtol=1e-4, atol=1e-5
    )
    assert float(post.log_evidence) == pytest.approx(logZ_bf, rel=1e-5)


def test_forward_backward_batched():
    rng = np.random.default_rng(1)
    B, T, K = 5, 8, 3
    log_lik = rng.normal(size=(B, T, K))
    A = np.full((K, K), 1.0 / K)
    pi = np.full(K, 1.0 / K)
    post = hmm_forward_backward(
        jnp.asarray(log_lik), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )
    assert post.log_gamma.shape == (B, T, K)
    assert post.log_xi_sum.shape == (B, K, K)
    assert post.log_evidence.shape == (B,)
    # Marginals normalize.
    np.testing.assert_allclose(
        np.exp(np.asarray(post.log_gamma)).sum(-1), 1.0, rtol=1e-5
    )
    # Batched run matches per-replica runs.
    single = hmm_forward_backward(
        jnp.asarray(log_lik[2]), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )
    np.testing.assert_allclose(
        np.asarray(post.log_gamma[2]), np.asarray(single.log_gamma), rtol=1e-5
    )


def test_viterbi_matches_enumeration():
    rng = np.random.default_rng(2)
    T, K = 7, 3
    log_lik = rng.normal(size=(T, K))
    A = rng.random((K, K)) + 0.1
    A /= A.sum(axis=1, keepdims=True)
    pi = np.full(K, 1.0 / K)

    path = hmm_viterbi(
        jnp.asarray(log_lik), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )

    best_lp, best_path = -np.inf, None
    for cand in itertools.product(range(K), repeat=T):
        lp = np.log(pi[cand[0]]) + log_lik[0, cand[0]]
        for t in range(1, T):
            lp += np.log(A[cand[t - 1], cand[t]]) + log_lik[t, cand[t]]
        if lp > best_lp:
            best_lp, best_path = lp, cand
    assert tuple(np.asarray(path)) == best_path


def _sample_hmm(rng, T, A, B, pi):
    K, M = B.shape
    z = rng.choice(K, p=pi)
    zs, ys = [], []
    for _ in range(T):
        ys.append(rng.choice(M, p=B[z]))
        zs.append(z)
        z = rng.choice(K, p=A[z])
    return np.array(zs), np.array(ys)


def test_dirichlet_vmp_recovers_structure():
    """Sticky 2-state HMM with near-deterministic emissions: VMP should
    recover high self-transition probability and the emission map."""
    rng = np.random.default_rng(3)
    A = np.array([[0.9, 0.1], [0.1, 0.9]])
    B = np.array([[0.95, 0.05], [0.05, 0.95]])
    pi = np.array([0.5, 0.5])
    _, y = _sample_hmm(rng, 500, A, B, pi)

    model = HMM(K=2, log_pi=jnp.log(jnp.asarray(pi)))
    result = model.fit_vmp(jnp.asarray(y), n_symbols=2, n_iterations=30)

    A_hat = np.asarray(
        result.state.trans_alpha / result.state.trans_alpha.sum(-1, keepdims=True)
    )
    B_hat = np.asarray(
        result.state.emis_alpha / result.state.emis_alpha.sum(-1, keepdims=True)
    )
    # Label switching: align by emission signature.
    order = np.argsort(B_hat[:, 1])
    A_hat = A_hat[order][:, order]
    B_hat = B_hat[order]
    assert A_hat[0, 0] > 0.8 and A_hat[1, 1] > 0.8
    assert B_hat[0, 0] > 0.85 and B_hat[1, 1] > 0.85
    assert np.isfinite(float(result.elbo))


def test_vmp_elbo_increases():
    rng = np.random.default_rng(4)
    A = np.array([[0.8, 0.2], [0.3, 0.7]])
    B = np.array([[0.9, 0.1], [0.2, 0.8]])
    _, y = _sample_hmm(rng, 200, A, B, np.array([0.5, 0.5]))
    model = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))

    elbos = []
    state = None
    for i in [1, 2, 5, 10, 20]:
        r = model.fit_vmp(jnp.asarray(y), n_symbols=2, n_iterations=i)
        elbos.append(float(r.elbo))
    # Monotone (tolerating tiny float noise).
    for a, b in zip(elbos, elbos[1:]):
        assert b >= a - 1e-3


def test_vmp_replica_batched():
    rng = np.random.default_rng(5)
    A = np.array([[0.9, 0.1], [0.2, 0.8]])
    B = np.array([[0.9, 0.1], [0.1, 0.9]])
    ys = np.stack(
        [_sample_hmm(rng, 100, A, B, np.array([0.5, 0.5]))[1] for _ in range(6)]
    )
    model = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))
    result = model.fit_vmp(jnp.asarray(ys), n_symbols=2, n_iterations=10)
    assert result.state.trans_alpha.shape == (6, 2, 2)
    assert result.elbo.shape == (6,)
    # Per-replica result matches the batched one.
    single = model.fit_vmp(jnp.asarray(ys[3]), n_symbols=2, n_iterations=10)
    np.testing.assert_allclose(
        np.asarray(result.state.trans_alpha[3]),
        np.asarray(single.state.trans_alpha),
        rtol=1e-4,
    )


def test_fit_vmp_jits():
    model = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))
    fit = jax.jit(
        lambda y: model.fit_vmp(y, n_symbols=2, n_iterations=5).elbo
    )
    y = jnp.asarray(np.random.default_rng(6).integers(0, 2, size=(4, 50)))
    out = fit(y)
    assert out.shape == (4,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_fit_vmp_pooled_and_pallas_agree():
    """Pooled VMP: one shared posterior from many sequences; the pallas
    E-step (interpret mode on CPU) matches the log-space scan."""
    rng = np.random.default_rng(9)
    A = np.array([[0.85, 0.15], [0.25, 0.75]])
    B = np.array([[0.9, 0.1], [0.15, 0.85]])
    ys = np.stack(
        [_sample_hmm(rng, 80, A, B, np.array([0.5, 0.5]))[1] for _ in range(8)]
    )
    model = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))

    r_scan = model.fit_vmp(
        jnp.asarray(ys), n_symbols=2, n_iterations=15, pooled=True
    )
    assert r_scan.state.trans_alpha.shape == (2, 2)  # one shared posterior
    r_pallas = model.fit_vmp(
        jnp.asarray(ys), n_symbols=2, n_iterations=15, pooled=True,
        method="pallas", interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(r_scan.state.trans_alpha),
        np.asarray(r_pallas.state.trans_alpha),
        rtol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(r_scan.elbo), np.asarray(r_pallas.elbo), rtol=1e-3
    )

    # Pooled recovery beats single-sequence noise.
    A_hat = np.asarray(
        r_scan.state.trans_alpha / r_scan.state.trans_alpha.sum(-1, keepdims=True)
    )
    order = np.argsort(A_hat[:, 0])[::-1]
    A_hat = A_hat[order][:, order]
    assert abs(A_hat[0, 0] - 0.85) < 0.1


def test_fit_vmp_pallas_requires_pooled():
    model = HMM(K=2, log_pi=jnp.log(jnp.full(2, 0.5)))
    with pytest.raises(ValueError, match="pooled"):
        model.fit_vmp(
            jnp.zeros((4, 10), dtype=jnp.int32), n_symbols=2, method="pallas"
        )


def test_smooth_pallas_matches_scan():
    rng = np.random.default_rng(11)
    R_, T, K = 6, 20, 3
    log_lik = jnp.asarray(rng.normal(size=(R_, T, K)).astype(np.float32))
    A = rng.random((K, K)).astype(np.float32) + 0.2
    A /= A.sum(1, keepdims=True)
    model = HMM(K=K, log_pi=jnp.log(jnp.full(K, 1.0 / K)))

    ref = model.smooth(log_lik, jnp.log(jnp.asarray(A)))
    pal = model.smooth(log_lik, jnp.log(jnp.asarray(A)), method="pallas",
                       interpret=True)
    np.testing.assert_allclose(
        np.exp(np.asarray(pal.log_gamma)),
        np.exp(np.asarray(ref.log_gamma)),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(pal.log_evidence), np.asarray(ref.log_evidence), rtol=1e-4
    )
