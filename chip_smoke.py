#!/usr/bin/env python3
"""Smoke test of cortex_tpu's main path on an NVIDIA GPU, at real sizes.

    python chip_smoke.py          # one card: every single-card phase
    python chip_smoke.py --four   # four cards: the replica- and time-sharded
                                  # paths, each against the same call on one

Each phase drives the public API once, compares every result with a plain
reference — float64 NumPy/SciPy on the host, or an XLA path run under
``jax.default_matmul_precision("highest")`` — and prints one line: its
largest absolute and scale-relative error, the tolerance and why it is
that, the first call's time (compilation included) and the steady time.
The hand-written Pallas kernels run compiled for the card (never in the
interpreter) and are also compared directly with the XLA path they replace.

The script refuses to run without a GPU.  It exits non-zero if any phase
fails; otherwise its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

The phase functions take their sizes (and ``interpret``) as arguments so the
CPU tests can run them at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# --------------------------------------------------------------------------
# Comparison and timing helpers


def compare(name, got, want, tol, why):
    """One check, as a dict: ``max_abs``, ``max_rel`` (absolute error over
    the reference's largest magnitude, floored at 1), ``tol`` on
    ``max_rel``, ``why`` (the reason for the tolerance) and ``ok``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return dict(name=name, ok=False, tol=tol,
                    why=f"shape {got.shape} != {want.shape}")
    err = np.abs(got - want)
    max_abs = float(err.max()) if err.size else 0.0
    max_rel = max_abs / max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    ok = bool(np.isfinite(got).all()) and max_rel <= tol
    return dict(name=name, ok=ok, max_abs=max_abs, max_rel=max_rel, tol=tol,
                why=why)


def timed(fn, *args, reps=3):
    """``(output, first_call_s, steady_ms)``: the first call compiles; the
    steady time is the median of ``reps`` more calls, each blocked on."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times) * 1e3


def _walks(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).cumsum(axis=-1) * scale).astype(np.float32)


F32_RECURSION = "float32 recursion vs float64; stable filter, error stays O(eps*|y|)"

# --------------------------------------------------------------------------
# float64 host references


def ref_scalar_smoother(y, A=1.0, Q=1.0, H=1.0, R=1.0):
    """Kalman filter + RTS smoother in covariance form, float64, batched
    over replicas; no prior on x_0 (first belief is N(y_0/H, R/H^2))."""
    y = np.asarray(y, np.float64)
    n, T = y.shape
    m_f = np.empty((n, T))
    P_f = np.empty(T)
    P_p = np.empty(T)
    m_f[:, 0] = y[:, 0] / H
    P_f[0] = R / (H * H)
    for t in range(1, T):
        P_p[t] = A * A * P_f[t - 1] + Q
        K = P_p[t] * H / (H * H * P_p[t] + R)
        m_p = A * m_f[:, t - 1]
        m_f[:, t] = m_p + K * (y[:, t] - H * m_p)
        P_f[t] = (1.0 - K * H) * P_p[t]
    m_s = m_f.copy()
    P_s = P_f.copy()
    for t in range(T - 2, -1, -1):
        G = P_f[t] * A / P_p[t + 1]
        m_s[:, t] = m_f[:, t] + G * (m_s[:, t + 1] - A * m_f[:, t])
        P_s[t] = P_f[t] + G * G * (P_s[t + 1] - P_p[t + 1])
    return m_s, np.broadcast_to(P_s, (n, T))


def ref_mv_smoother(y, A, Q, H, R, m0, P0):
    """Multivariate Kalman/RTS, float64.  ``y``: ``(n, T, m)``; dense data,
    so the covariances are shared by all replicas."""
    y = np.asarray(y, np.float64)
    n, T, _ = y.shape
    d = A.shape[0]
    m_f = np.empty((n, T, d))
    P_f = np.empty((T, d, d))
    P_p = np.empty((T, d, d))
    m_pred = np.broadcast_to(m0, (n, d))
    P_pred = P0
    for t in range(T):
        if t:
            m_pred = m_f[:, t - 1] @ A.T
            P_pred = A @ P_f[t - 1] @ A.T + Q
        P_p[t] = P_pred
        S = H @ P_pred @ H.T + R
        K = np.linalg.solve(S, H @ P_pred).T  # P H^T S^-1
        m_f[:, t] = m_pred + (y[:, t] - m_pred @ H.T) @ K.T
        P_f[t] = P_pred - K @ H @ P_pred
    m_s = m_f.copy()
    P_s = P_f.copy()
    for t in range(T - 2, -1, -1):
        G = np.linalg.solve(P_p[t + 1], A @ P_f[t]).T  # P_f A^T P_p^-1
        m_s[:, t] = m_f[:, t] + (m_s[:, t + 1] - m_f[:, t] @ A.T) @ G.T
        P_s[t] = P_f[t] + G @ (P_s[t + 1] - P_p[t + 1]) @ G.T
    return m_s, np.broadcast_to(P_s, (n, T, d, d))


def ref_forward_backward(lik, A, pi):
    """Scaled forward-backward, float64: ``(gamma, xi_sum, log_evidence)``."""
    lik = np.asarray(lik, np.float64)
    A = np.asarray(A, np.float64)
    n, T, K = lik.shape
    alpha = np.empty((n, T, K))
    c = np.empty((n, T))
    a = pi[None, :] * lik[:, 0]
    c[:, 0] = a.sum(1)
    alpha[:, 0] = a / c[:, 0, None]
    for t in range(1, T):
        a = (alpha[:, t - 1] @ A) * lik[:, t]
        c[:, t] = a.sum(1)
        alpha[:, t] = a / c[:, t, None]
    beta = np.ones((n, K))
    gamma = np.empty((n, T, K))
    gamma[:, T - 1] = alpha[:, T - 1]
    xi_sum = np.zeros((n, K, K))
    for t in range(T - 2, -1, -1):
        w = lik[:, t + 1] * beta
        xi = alpha[:, t, :, None] * A[None] * w[:, None, :]
        xi_sum += xi / xi.sum((1, 2), keepdims=True)
        beta = w @ A.T / c[:, t + 1, None]
        g = alpha[:, t] * beta
        gamma[:, t] = g / g.sum(1, keepdims=True)
    return gamma, xi_sum, np.log(c).sum(1)


def ref_hmm_vmp(obs, K, M, n_iterations, trans_prior=1.0, emis_prior=1.0):
    """Pooled Dirichlet VMP for a categorical HMM (uniform initial state),
    float64 — the updates of ``HMM.fit_vmp(pooled=True)``."""
    from scipy.special import digamma, gammaln

    obs = np.asarray(obs)
    onehot = np.eye(M)[obs]  # (n, T, M)
    trans = trans_prior + 0.5 * np.eye(K)
    emis = emis_prior + 0.25 * np.eye(M)[np.arange(K) % M]
    tp = np.full((K, K), trans_prior)
    ep = np.full((K, M), emis_prior)
    pi = np.full(K, 1.0 / K)

    def mean_log(a):
        return digamma(a) - digamma(a.sum(-1, keepdims=True))

    def kl(q, p):
        q0, p0 = q.sum(-1), p.sum(-1)
        return (gammaln(q0) - gammaln(q).sum(-1) - gammaln(p0)
                + gammaln(p).sum(-1)
                + ((q - p) * (digamma(q) - digamma(q0)[..., None])).sum(-1))

    for _ in range(n_iterations):
        log_B = mean_log(emis)
        lik = np.exp(onehot @ log_B.T)
        gamma, xi_sum, log_ev = ref_forward_backward(
            lik, np.exp(mean_log(trans)), pi
        )
        trans = tp + xi_sum.sum(0)
        emis = ep + np.einsum("ntk,ntm->km", gamma, onehot)
        elbo = log_ev.sum() - kl(trans, tp).sum() - kl(emis, ep).sum()
    return trans, emis, elbo


def ref_hgf(u, kappa=1.0, omega=-2.0, theta=0.05, pi_u=10.0, max_log_nu=20.0,
            min_pi2=1e-2, max_mu2_step=5.0):
    """The HGF update of ``HGF.step``, float64: final state and the five
    tracks (mu1, pi1, mu2, pi2, delta1), each ``(n, T)``."""
    u = np.asarray(u, np.float64)
    n, T = u.shape
    mu1, pi1 = np.zeros(n), np.ones(n)
    mu2, pi2 = np.zeros(n), np.ones(n)
    tracks = np.empty((5, n, T))
    for t in range(T):
        nu = np.exp(np.clip(kappa * mu2 + omega, -max_log_nu, max_log_nu))
        pihat1 = 1.0 / (1.0 / pi1 + nu)
        pi1_new = pihat1 + pi_u
        mu1_new = mu1 + (pi_u / pi1_new) * (u[:, t] - mu1)
        delta1 = (1.0 / pi1_new + (mu1_new - mu1) ** 2) * pihat1 - 1.0
        pihat2 = 1.0 / (1.0 / pi2 + theta)
        w1 = nu * pihat1
        pi2 = np.maximum(
            pihat2 + 0.5 * kappa**2 * w1 * (w1 + (2.0 * w1 - 1.0) * delta1),
            min_pi2,
        )
        mu2 = mu2 + np.clip(0.5 * kappa * (w1 / pi2) * delta1,
                            -max_mu2_step, max_mu2_step)
        mu1, pi1 = mu1_new, pi1_new
        tracks[:, :, t] = mu1, pi1, mu2, pi2, delta1
    return (mu1, pi1, mu2, pi2), tracks


def ref_mean_field_vmp(data, iters):
    """The mean-field SSM's synchronous VMP sweep (unknown process and
    observation precisions, unit Gamma(1, 1) priors), float64:
    ``(E[tau_ss], E[tau_obs], q(x_0) mean)`` per replica."""
    data = np.asarray(data, np.float64)
    n = data.shape[1]
    qm = np.zeros_like(data)
    qv = np.ones_like(data)
    qss = np.ones(data.shape[0])
    qobs = np.ones(data.shape[0])
    has_l = np.ones(n)
    has_l[0] = 0.0
    has_r = np.ones(n)
    has_r[-1] = 0.0
    for _ in range(iters):
        left = np.pad(qm[:, :-1], ((0, 0), (1, 0)))
        right = np.pad(qm[:, 1:], ((0, 0), (0, 1)))
        prec = qobs[:, None] + qss[:, None] * (has_l + has_r)
        wmean = qobs[:, None] * data + qss[:, None] * (left + right)
        rate_obs = 0.5 * (qv + (data - qm) ** 2)
        rate_ss = 0.5 * (qv[:, :-1] + qv[:, 1:] + (qm[:, :-1] - qm[:, 1:]) ** 2)
        qobs = (1.5 * n - (n - 1.0)) / rate_obs.sum(1)
        qss = (1.5 * (n - 1.0) - (n - 2.0)) / rate_ss.sum(1)
        qm, qv = wmean / prec, 1.0 / prec
    return qss, qobs, qm[:, 0]


# --------------------------------------------------------------------------
# Single-card phases.  Each returns a list of checks (see ``compare``); the
# first check of each call also carries its first-call and steady times.


def _with_times(check, first_s, steady_ms):
    check.update(first_call_s=first_s, steady_ms=steady_ms)
    return check


def phase_lgssm(R, T, interpret=False):
    """Scalar LGSSM smoothing: the default path (scan), the matmul path, and
    the Triton kernel, against float64 RTS; the kernel also against the
    XLA scan."""
    import jax

    from cortex_tpu.models import LGSSM
    from cortex_tpu.ops import lgssm_smooth_pallas, lgssm_smooth_scan

    y = jax.numpy.asarray(_walks((R, T), seed=R + T))
    m_ref, v_ref = ref_scalar_smoother(y)
    model = LGSSM()
    out = []
    results = {}
    for name, fn in (
        ("scan", jax.jit(lambda y: model.smooth(y))),
        ("matmul", jax.jit(lambda y: model.smooth(y, method="matmul"))),
        ("pallas", lambda y: lgssm_smooth_pallas(y, interpret=interpret)),
    ):
        res, first, steady = timed(fn, y)
        results[name] = res
        why = F32_RECURSION
        if name == "matmul":
            why = "one float32 product at HIGHEST over T terms vs float64"
        out.append(_with_times(
            compare(f"lgssm[{name}].mean {R}x{T}", res.mean, m_ref, 1e-5, why),
            first, steady))
        out.append(compare(f"lgssm[{name}].var {R}x{T}", res.variance, v_ref,
                           1e-5, why))
    with jax.default_matmul_precision("highest"):
        xla_ref = jax.jit(lgssm_smooth_scan)(y)
    out.append(compare(
        f"lgssm[pallas vs xla scan].mean {R}x{T}", results["pallas"].mean,
        xla_ref.mean, 1e-5,
        "two float32 evaluations of the same sweep, different op order"))
    return out


def _mv_model(d, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    A = 0.95 * q
    B = rng.standard_normal((d, d)) / np.sqrt(d)
    Q = 0.1 * np.eye(d) + 0.05 * B @ B.T
    H = np.eye(d) + 0.3 * rng.standard_normal((d, d)) / np.sqrt(d)
    Rm = 0.5 * np.eye(d)
    return A, Q, H, Rm, np.zeros(d), np.eye(d)


def phase_mv_lgssm(R, T, d):
    """Multivariate LGSSM smoothing (``method="auto"``) with a coupled,
    random stable model, against float64 Kalman/RTS."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import MvLGSSM

    A, Q, H, Rm, m0, P0 = _mv_model(d, seed=d)
    model = MvLGSSM.from_arrays(A, Q, H, Rm, m0, P0)
    y = jnp.asarray(np.swapaxes(_walks((R, d, T), seed=d, scale=0.3), 1, 2))
    m_ref, P_ref = ref_mv_smoother(y, A, Q, H, Rm, m0, P0)
    res, first, steady = timed(jax.jit(lambda y: model.smooth(y)), y)
    why = (f"float32 {d}x{d} solves over T={T} steps vs float64 "
           f"({model.auto_method()} path)")
    return [
        _with_times(compare(f"mv_lgssm d={d} mean {R}x{T}", res.mean, m_ref,
                            1e-4, why), first, steady),
        compare(f"mv_lgssm d={d} cov {R}x{T}", res.cov, P_ref, 1e-4, why),
    ]


def phase_compiled_bp(R, T):
    """CompiledInference over the gold chain graph (BP, unit parameters)
    against float64 RTS."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.compile import CompiledInference, smart_stack
    from cortex_tpu.models import LGSSMChainBatched, make_chain_graph

    engine, x, yv, _ = make_chain_graph(T)
    compiled = CompiledInference(engine, x, LGSSMChainBatched())
    order = {v: i for i, v in enumerate(yv)}
    perm = jnp.asarray([order[k[1]] for k in compiled.source_keys()])

    def fn(data):
        marginals, _ = compiled.run({}, source_pack=data.T[perm], packed=True)
        fam = smart_stack([marginals[xi] for xi in x])  # (T, R)
        return fam.mean.T, fam.variance.T

    y = jnp.asarray(_walks((R, T), seed=7))
    m_ref, v_ref = ref_scalar_smoother(y)
    (mean, var), first, steady = timed(jax.jit(fn), y)
    return [
        _with_times(compare(f"compiled_bp.mean {R}x{T}", mean, m_ref, 1e-5,
                            F32_RECURSION), first, steady),
        compare(f"compiled_bp.var {R}x{T}", var, v_ref, 1e-5, F32_RECURSION),
    ]


def phase_compiled_vmp(R, n, iters):
    """Mean-field VMP fixed point through CompiledInference against the
    same synchronous sweep in float64."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.compile import CompiledInference, dep_role_key
    from cortex_tpu.models import MeanFieldSSMBatched, make_mean_field_ssm_graph

    engine, x, y, ssnoise, obsnoise = make_mean_field_ssm_graph(n, [0.0] * n)
    compiled = CompiledInference(engine, [ssnoise, obsnoise] + x,
                                 MeanFieldSSMBatched(), refine_key=dep_role_key)
    base = compiled.initial_state()
    y_pos = {id(engine.get_variable_marginal(v)): i for i, v in enumerate(y)}

    def fn(data):
        state = []
        for s, v in zip(compiled.schedule.initials, base):
            if id(s) in y_pos:
                state.append(data[:, y_pos[id(s)]])
            else:
                state.append(jax.tree_util.tree_map(
                    lambda a: jnp.broadcast_to(jnp.asarray(a),
                                               (R,) + jnp.shape(a)), v))
        marg, _ = compiled.iterate({}, iters, state)
        return marg[ssnoise].mean, marg[obsnoise].mean, marg[x[0]].mean

    data = jnp.asarray(_walks((R, n), seed=11, scale=0.1))
    refs = ref_mean_field_vmp(data, iters)
    got, first, steady = timed(jax.jit(fn), data)
    why = f"float32 sweep vs float64, {iters} iterations over n={n} sums"
    names = ("E[tau_ss]", "E[tau_obs]", "q(x_0).mean")
    out = [compare(f"compiled_vmp {nm} {R}x{n}", g, r, 1e-4, why)
           for nm, g, r in zip(names, got, refs)]
    _with_times(out[0], first, steady)
    return out


def phase_hmm(R, T, K, M, iters, interpret=False):
    """HMM Dirichlet VMP (``fit_vmp``, pooled) through the log-space scan
    and the Triton E-step kernel, against float64 VMP."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import HMM

    rng = np.random.default_rng(5)
    obs = jnp.asarray(rng.integers(0, M, size=(R, T)), jnp.int32)
    trans_ref, emis_ref, elbo_ref = ref_hmm_vmp(obs, K, M, iters)
    hmm = HMM(K=K, log_pi=jnp.log(jnp.full(K, 1.0 / K)))
    out = []
    why = (f"float32 counts summed over R*T={R * T} steps vs float64, "
           f"{iters} iterations")
    for method in ("scan", "pallas"):
        fn = jax.jit(lambda o, method=method: hmm.fit_vmp(
            o, n_symbols=M, n_iterations=iters, pooled=True, method=method,
            interpret=interpret))
        res, first, steady = timed(fn, obs)
        out.append(_with_times(compare(
            f"hmm_vmp[{method}].trans_alpha {R}x{T} K={K}",
            res.state.trans_alpha, trans_ref, 1e-4, why), first, steady))
        out.append(compare(f"hmm_vmp[{method}].emis_alpha {R}x{T} K={K}",
                           res.state.emis_alpha, emis_ref, 1e-4, why))
        out.append(compare(f"hmm_vmp[{method}].elbo {R}x{T} K={K}",
                           res.elbo, elbo_ref, 1e-4, why))

    return out


def phase_hmm_kernel(R, T, K, interpret=False):
    """The Triton forward-backward kernel against float64 and directly
    against the XLA log-space forward-backward it replaces."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.ops.hmm import hmm_forward_backward
    from cortex_tpu.ops.pallas_hmm import hmm_forward_backward_counts_pallas

    rng = np.random.default_rng(K)
    lik = jnp.asarray(rng.random((R, T, K)) + 0.1, jnp.float32)
    A = rng.random((K, K)) + 0.2
    A = jnp.asarray(A / A.sum(1, keepdims=True), jnp.float32)
    pi = jnp.full((K,), 1.0 / K, jnp.float32)
    g_ref, xi_ref, lz_ref = ref_forward_backward(lik, A, np.asarray(pi))
    kern, first, steady = timed(
        lambda *a: hmm_forward_backward_counts_pallas(*a, interpret=interpret),
        lik, A, pi)

    @jax.jit
    def xla(lik, A, pi):
        post = hmm_forward_backward(jnp.log(lik), jnp.log(A), jnp.log(pi))
        return (jnp.exp(post.log_gamma), jnp.exp(post.log_xi_sum),
                post.log_evidence)

    with jax.default_matmul_precision("highest"):
        xg, xxi, xlz = xla(lik, A, pi)
    why = f"float32 scaled recursion vs float64 over T={T}"
    out = [
        _with_times(compare(f"hmm_fb[pallas].gamma {R}x{T} K={K}",
                            kern.gamma, g_ref, 1e-5, why), first, steady),
        compare(f"hmm_fb[pallas].xi_sum {R}x{T} K={K}", kern.xi_sum, xi_ref,
                1e-5, why),
        compare(f"hmm_fb[pallas].log_evidence {R}x{T} K={K}",
                kern.log_evidence, lz_ref, 1e-5, why),
    ]
    why = ("the log-space scan carries unnormalized log-messages of size ~T, "
           "so its float32 error grows with T (1.4e-5 at T=64)")
    out += [
        compare(f"hmm_fb[pallas vs xla].gamma {R}x{T} K={K}", kern.gamma, xg,
                5e-5, why),
        compare(f"hmm_fb[pallas vs xla].xi_sum {R}x{T} K={K}", kern.xi_sum,
                xxi, 5e-5, why),
        compare(f"hmm_fb[xla].log_evidence {R}x{T} K={K}", xlz, lz_ref, 1e-5,
                "float32 log-space recursion vs float64"),
    ]
    return out


def phase_hgf(R, T, interpret=False):
    """Streaming HGF filter through the scan and the Triton kernel (all five
    tracks, and filter-only), against float64; the kernel also directly
    against the XLA scan."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import HGF

    hgf = HGF()
    u = jnp.asarray(_walks((R, T), seed=3, scale=0.1))
    fin_ref, tr_ref = ref_hgf(u)
    names = ("mu1", "pi1", "mu2", "pi2", "delta1")
    why = f"float32 recursion with exp/clip guards vs float64 over T={T}"
    out = []
    results = {}
    for method in ("scan", "pallas"):
        for tracks in (None, ()):
            fn = jax.jit(lambda u, method=method, tracks=tracks: hgf.filter(
                u, method=method, tracks=tracks, interpret=interpret))
            (fin, traj), first, steady = timed(fn, u)
            label = f"hgf[{method}{'' if tracks is None else ',filter-only'}]"
            results[label] = (fin, traj)
            finals = [compare(f"{label}.final.{name} {R}x{T}", got, want, 1e-4,
                              why)
                      for name, got, want in zip(names[:4], fin, fin_ref)]
            out += [_with_times(finals[0], first, steady)] + finals[1:]
            if tracks is None:
                for name, got, want in zip(names, traj, tr_ref):
                    out.append(compare(f"{label}.{name} {R}x{T}", got, want,
                                       1e-4, why))
    with jax.default_matmul_precision("highest"):
        _, xla_traj = jax.jit(hgf.filter)(u)
    why = "two float32 evaluations of the same update, different op order"
    for name, got, want in zip(names, results["hgf[pallas]"][1], xla_traj):
        out.append(compare(f"hgf[pallas vs xla scan].{name} {R}x{T}", got,
                           want, 1e-5, why))
    return out


def phase_serve(R, T, batches):
    """A BucketedServer answering ragged batches of the default smoother,
    one ahead-of-time compile and one ``jax.export`` round trip, against
    float64 RTS.  (Serializing the export needs the ``flatbuffers``
    package, which a GPU host need not have.)"""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import LGSSM
    from cortex_tpu.serve import BucketedServer, aot_compile

    model = LGSSM()

    def smooth_mean(y):
        return model.smooth(y).mean

    y = jnp.asarray(_walks((R, T), seed=13))
    m_ref, _ = ref_scalar_smoother(y)
    server = BucketedServer(smooth_mean, (y[:8],), max_batch=R, min_bucket=8)
    out = []
    for b in batches:
        got, first, steady = timed(server, y[:b])
        out.append(_with_times(compare(
            f"serve batch={b} (bucket {min(x for x in server.buckets if x >= b)})",
            got, m_ref[:b], 1e-5, F32_RECURSION), first, steady))
    compiled = aot_compile(smooth_mean, y[:64])
    got, first, steady = timed(compiled, y[:64])
    out.append(_with_times(compare(
        f"aot_compile 64x{T}", got, m_ref[:64], 1e-5, F32_RECURSION),
        first, steady))
    spec = jax.ShapeDtypeStruct((64, T), y.dtype)
    exported = jax.export.export(jax.jit(smooth_mean))(spec)
    got, first, steady = timed(jax.jit(exported.call), y[:64])
    out.append(_with_times(compare(
        f"jax.export round trip 64x{T}", got, m_ref[:64], 1e-5,
        F32_RECURSION), first, steady))
    return out


# --------------------------------------------------------------------------
# Four-card phases: each sharded call against the same call on one card.


def phase_replica_sharded(R, T, devices):
    """``shard_replicas`` + the jitted scalar smoother over a ("replica", n)
    mesh, against the same jitted call on one card and float64 RTS."""
    import jax

    from cortex_tpu.models import LGSSM
    from cortex_tpu.parallel import make_mesh, shard_replicas

    mesh = make_mesh([("replica", len(devices))], devices)
    y = _walks((R, T), seed=17)
    fn = jax.jit(lambda y: LGSSM().smooth(y).mean)
    ys = shard_replicas(jax.numpy.asarray(y), mesh)
    got, first, steady = timed(fn, ys)
    one, first1, steady1 = timed(fn, jax.device_put(y, devices[0]))
    m_ref, _ = ref_scalar_smoother(y)
    c = _with_times(compare(f"replica_sharded x{len(devices)} vs one card {R}x{T}",
                            got, one, 1e-6, "same program per replica block"),
                    first, steady)
    c["one_card_steady_ms"] = steady1
    return [c, compare(f"replica_sharded x{len(devices)} vs float64 {R}x{T}",
                       got, m_ref, 1e-5, F32_RECURSION)]


def phase_time_sharded(R, T, devices):
    """``lgssm_smooth_time_sharded`` over a ("time", n) mesh against the same
    call over a one-card mesh, and float64 RTS."""
    import jax

    from cortex_tpu.parallel import lgssm_smooth_time_sharded, make_mesh

    y = jax.numpy.asarray(_walks((R, T), seed=19, scale=0.05))
    outs = {}
    for n in (len(devices), 1):
        mesh = make_mesh([("time", n)], devices[:n])
        fn = jax.jit(lambda y, mesh=mesh: lgssm_smooth_time_sharded(y, mesh=mesh))
        outs[n] = timed(fn, y)
    (got, first, steady), (one, _, steady1) = outs[len(devices)], outs[1]
    m_ref, v_ref = ref_scalar_smoother(y)
    why = "associative-scan elements combined in another order"
    c = _with_times(compare(f"time_sharded x{len(devices)} vs one card {R}x{T}",
                            got.mean, one.mean, 1e-5, why), first, steady)
    c["one_card_steady_ms"] = steady1
    return [
        c,
        compare(f"time_sharded x{len(devices)}.mean vs float64 {R}x{T}",
                got.mean, m_ref, 1e-4,
                "float32 associative scan over T (log T combine depth)"),
        compare(f"time_sharded x{len(devices)}.var vs float64 {R}x{T}",
                got.variance, v_ref, 1e-4,
                "float32 associative scan over T (log T combine depth)"),
    ]


def phase_mv_time_sharded(R, T, d, devices):
    """``mv_lgssm_smooth_time_sharded`` over a ("time", n) mesh against the
    same call over a one-card mesh, and float64 Kalman/RTS."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.parallel import make_mesh, mv_lgssm_smooth_time_sharded

    A, Q, H, Rm, m0, P0 = _mv_model(d, seed=d)
    y = jnp.asarray(np.swapaxes(_walks((R, d, T), seed=23, scale=0.3), 1, 2))
    args = tuple(jnp.asarray(a, jnp.float32) for a in (A, Q, H, Rm))
    prior = (jnp.asarray(m0, jnp.float32), jnp.asarray(P0, jnp.float32))
    outs = {}
    for n in (len(devices), 1):
        mesh = make_mesh([("time", n)], devices[:n])
        fn = jax.jit(lambda y, mesh=mesh: mv_lgssm_smooth_time_sharded(
            y, *args, prior, mesh=mesh))
        outs[n] = timed(fn, y)
    (got, first, steady), (one, _, steady1) = outs[len(devices)], outs[1]
    m_ref, P_ref = ref_mv_smoother(y, A, Q, H, Rm, m0, P0)
    why = f"float32 {d}x{d} element algebra vs float64"
    c = _with_times(compare(
        f"mv_time_sharded d={d} x{len(devices)} vs one card {R}x{T}",
        got.mean, one.mean, 1e-4,
        "block elements combined in another order"), first, steady)
    c["one_card_steady_ms"] = steady1
    return [
        c,
        compare(f"mv_time_sharded d={d} x{len(devices)}.mean vs float64",
                got.mean, m_ref, 1e-4, why),
        compare(f"mv_time_sharded d={d} x{len(devices)}.cov vs float64",
                got.cov, P_ref, 1e-4, why),
    ]


# --------------------------------------------------------------------------

ONE_CARD = (
    ("lgssm 10k x 100", phase_lgssm, dict(R=10_000, T=100)),
    ("lgssm 100k x 1000", phase_lgssm, dict(R=100_000, T=1000)),
    ("mv_lgssm d=4", phase_mv_lgssm, dict(R=4096, T=100, d=4)),
    ("mv_lgssm d=16", phase_mv_lgssm, dict(R=1024, T=100, d=16)),
    ("compiled bp", phase_compiled_bp, dict(R=10_000, T=100)),
    ("compiled vmp", phase_compiled_vmp, dict(R=10_000, n=100, iters=4)),
    ("hmm vmp", phase_hmm, dict(R=4096, T=64, K=4, M=8, iters=4)),
    ("hmm kernel K=4", phase_hmm_kernel, dict(R=4096, T=64, K=4)),
    ("hmm kernel K=8", phase_hmm_kernel, dict(R=4096, T=64, K=8)),
    ("hmm kernel K=16", phase_hmm_kernel, dict(R=4096, T=64, K=16)),
    ("hgf", phase_hgf, dict(R=65_536, T=256)),
    ("serve", phase_serve, dict(R=256, T=100, batches=(100, 37, 256))),
)


def four_card_phases(devices):
    return (
        ("replica sharded", phase_replica_sharded,
         dict(R=40_000, T=100, devices=devices)),
        ("time sharded", phase_time_sharded,
         dict(R=4096, T=65_536, devices=devices)),
        ("mv time sharded", phase_mv_time_sharded,
         dict(R=16, T=65_536, d=4, devices=devices)),
    )


def run_phases(phases, emit=print):
    """Run each phase, print one line per check; True iff all passed."""
    ok = True
    for label, fn, kwargs in phases:
        t0 = time.perf_counter()
        try:
            checks = fn(**kwargs)
        except Exception:
            emit(f"FAIL phase {label!r} raised:\n{traceback.format_exc()}")
            ok = False
            continue
        for c in checks:
            ok &= c["ok"]
            fields = " ".join(
                f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}"
                for k, v in c.items() if k not in ("name", "ok", "why")
            )
            emit(f"{'PASS' if c['ok'] else 'FAIL'} {c['name']} {fields} "
                 f"why={c.get('why')!r}")
        emit(f"phase {label!r} done in {time.perf_counter() - t0:.1f}s")
    return ok


def configure_compile_cache():
    """Keep JAX's compile cache where ``JAX_COMPILATION_CACHE_DIR`` says, or
    else at ``<repo>/.jax_cache``."""
    from cortex_tpu.serve import enable_persistent_cache

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        enable_persistent_cache(os.path.join(REPO, ".jax_cache"))


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    try:
        import cortex_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cortex_tpu is not importable ({e}); run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    configure_compile_cache()
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}",
          flush=True)

    def emit(line):
        print(line, flush=True)

    if args.four:
        devices = devices[:4]
        ok = run_phases(four_card_phases(devices), emit)
    else:
        devices = devices[:1]
        ok = run_phases(ONE_CARD, emit)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
