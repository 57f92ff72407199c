"""Nonlinear state-space smoothing: EKF and sigma-point (unscented) sweeps.

The reference's chain models are linear-Gaussian (sum-product messages stay
Gaussian, ``/root/reference/test/inference_engine_tests.jl:379-488``).  For
nonlinear dynamics/observations the messages have no closed form; the
standard framework answer is *projected* Gaussian message passing — linearize
(EKF) or moment-match through sigma points (UKF) — which keeps the same
forward/backward chain sweep structure the reference executes dynamically.

Design choices:

- Linearization Jacobians come from ``jax.jacfwd`` on the user's ``f``/``h``
  — no hand-derived derivatives (impossible in the reference, whose rules are
  opaque callables).
- One chain is a ``lax.scan``; replicas batch via ``vmap`` over leading axes,
  so a 10k-replica nonlinear smoothing sweep is one fused XLA program, the
  same execution shape as :mod:`cortex_tpu.ops.chains`.
- All covariance updates use SPD solves (never explicit inverses) and
  symmetrize, keeping bf16/f32-friendly conditioning.

Model (vector state ``d``, vector observation ``m``):

    x_1 ~ N(m0, P0),  x_t = f(x_{t-1}) + N(0, Q),  y_t = h(x_t) + N(0, R)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "NLSSMBeliefs",
    "ekf_filter",
    "ekf_smooth",
    "ukf_filter",
    "ukf_smooth",
]

from ..dists.gaussian import _spd_cholesky, _spd_solve_logdet

_LOG2PI = 1.8378770664093453


class NLSSMBeliefs(NamedTuple):
    """Gaussian beliefs over the states of a nonlinear chain.

    ``mean``: ``(..., T, d)``; ``cov``: ``(..., T, d, d)``;
    ``loglik``: ``(...,)`` — the (approximate) data log-evidence
    accumulated from the one-step prediction errors.
    """

    mean: jax.Array
    cov: jax.Array
    loglik: jax.Array


def _sym(P):
    return 0.5 * (P + jnp.swapaxes(P, -1, -2))


def _gaussian_ll(v, S):
    """log N(v; 0, S) — one pivotless SPD elimination for solve + logdet
    (no LU custom calls inside the per-step vmapped filters; see
    dists/gaussian._spd_solve_logdet)."""
    sol, logdet = _spd_solve_logdet(S, v[..., None])
    return -0.5 * (v.shape[-1] * _LOG2PI + logdet + v @ sol[..., 0])


def _apply_batched(core: Callable, y: jax.Array, core_ndim: int = 2):
    """Run ``core`` on ``(T, m)`` chains, vmapping over leading replica axes."""
    y = jnp.asarray(y)
    batch_shape = y.shape[: y.ndim - core_ndim]
    if not batch_shape:
        return core(y)
    flat = y.reshape((-1,) + y.shape[y.ndim - core_ndim :])
    out = jax.vmap(core)(flat)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch_shape + a.shape[1:]), out
    )


# ---------------------------------------------------------------------------
# EKF
# ---------------------------------------------------------------------------


def _ekf_pass(f, h, Q, R, m0, P0):
    """Returns core(y) -> (filtered beliefs, per-step smoother inputs)."""
    F_jac = jax.jacfwd(f)
    H_jac = jax.jacfwd(h)

    def update(m_pred, P_pred, obs):
        Hj = H_jac(m_pred)
        v = obs - h(m_pred)
        S = _sym(Hj @ P_pred @ Hj.T + R)
        K = _spd_solve_logdet(S, Hj @ P_pred)[0].T  # P Hjᵀ S⁻¹ (S symmetric)
        m = m_pred + K @ v
        P = _sym(P_pred - K @ S @ K.T)
        return m, P, _gaussian_ll(v, S)

    def core(y):
        m1, P1, ll1 = update(m0, P0, y[0])

        def step(carry, obs):
            m, P = carry
            Fj = F_jac(m)
            m_pred = f(m)
            P_pred = _sym(Fj @ P @ Fj.T + Q)
            m_u, P_u, ll = update(m_pred, P_pred, obs)
            # Smoother gain input: cross-cov C = P_filt Fjᵀ between x_t, x_{t+1}.
            return (m_u, P_u), (m_u, P_u, m_pred, P_pred, P @ Fj.T, ll)

        _, (ms, Ps, mps, Pps, Cs, lls) = lax.scan(step, (m1, P1), y[1:])
        mean = jnp.concatenate([m1[None], ms], axis=0)
        cov = jnp.concatenate([P1[None], Ps], axis=0)
        loglik = ll1 + jnp.sum(lls, axis=0)
        return mean, cov, loglik, mps, Pps, Cs

    return core


def _rts_backward(mean, cov, mps, Pps, Cs):
    """Generic RTS backward sweep given filtered beliefs and the per-step
    predictive moments + cross-covariances ``C_t = Cov[x_t, x_{t+1}|y_1:t]``
    (EKF: ``P_f Fᵀ``; UKF: the sigma-point cross moment)."""

    def back(carry, inp):
        ms_next, Ps_next = carry
        m_f, P_f, m_pred, P_pred, C = inp
        G = _spd_solve_logdet(P_pred, C.T)[0].T  # C P_pred⁻¹
        m_s = m_f + G @ (ms_next - m_pred)
        P_s = _sym(P_f + G @ (Ps_next - P_pred) @ G.T)
        return (m_s, P_s), (m_s, P_s, G)

    init = (mean[-1], cov[-1])
    inputs = (mean[:-1], cov[:-1], mps, Pps, Cs)
    _, (ms, Ps, Gs) = lax.scan(back, init, inputs, reverse=True)
    mean_s = jnp.concatenate([ms, mean[-1:]], axis=0)
    cov_s = jnp.concatenate([Ps, cov[-1:]], axis=0)
    return mean_s, cov_s, Gs


def ekf_filter(f, h, Q, R, y, m0, P0) -> NLSSMBeliefs:
    """Extended Kalman filtering: p(x_t | y_{1:t}) with first-order
    linearization at the running mean (Jacobians via ``jax.jacfwd``)."""
    Q, R, m0, P0 = map(jnp.asarray, (Q, R, m0, P0))

    def core(yc):
        mean, cov, ll, *_ = _ekf_pass(f, h, Q, R, m0, P0)(yc)
        return NLSSMBeliefs(mean, cov, ll)

    return _apply_batched(core, y)


def ekf_smooth(f, h, Q, R, y, m0, P0) -> NLSSMBeliefs:
    """Extended RTS smoothing: p(x_t | y_{1:T}); the nonlinear analogue of
    the chain BP sweep in :func:`cortex_tpu.ops.chains.lgssm_smooth_scan`."""
    Q, R, m0, P0 = map(jnp.asarray, (Q, R, m0, P0))

    def core(yc):
        mean, cov, ll, mps, Pps, Cs = _ekf_pass(f, h, Q, R, m0, P0)(yc)
        mean_s, cov_s, _ = _rts_backward(mean, cov, mps, Pps, Cs)
        return NLSSMBeliefs(mean_s, cov_s, ll)

    return _apply_batched(core, y)


# ---------------------------------------------------------------------------
# UKF (scaled unscented transform, Merwe weights)
# ---------------------------------------------------------------------------


def _ut_weights(d, alpha, beta, kappa, dtype):
    lam = alpha * alpha * (d + kappa) - d
    c = d + lam
    wm = jnp.full((2 * d + 1,), 1.0 / (2.0 * c), dtype=dtype)
    wm = wm.at[0].set(lam / c)
    wc = wm.at[0].set(lam / c + (1.0 - alpha * alpha + beta))
    return wm, wc, jnp.sqrt(c)


def _sigma_points(m, P, scale, jitter):
    d = m.shape[-1]
    L = _spd_cholesky(P + jitter * jnp.eye(d, dtype=P.dtype))
    offsets = scale * L.T  # rows are the scaled cholesky columns
    return jnp.concatenate([m[None], m[None] + offsets, m[None] - offsets], axis=0)


def _ut_moments(pts_in, pts_out, wm, wc, mean_in, noise):
    """Means, covariance and input-output cross-covariance of a transform."""
    mu = jnp.einsum("s,sd->d", wm, pts_out)
    d_out = pts_out - mu
    cov = jnp.einsum("s,si,sj->ij", wc, d_out, d_out) + noise
    d_in = pts_in - mean_in
    cross = jnp.einsum("s,si,sj->ij", wc, d_in, d_out)
    return mu, _sym(cov), cross


def _ukf_pass(f, h, Q, R, m0, P0, alpha, beta, kappa, jitter):
    d = m0.shape[-1]

    def update(m_pred, P_pred, obs, wm, wc, scale):
        pts = _sigma_points(m_pred, P_pred, scale, jitter)
        hpts = jax.vmap(h)(pts)
        y_hat, S, Cxy = _ut_moments(pts, hpts, wm, wc, m_pred, R)
        v = obs - y_hat
        K = _spd_solve_logdet(S, Cxy.T)[0].T  # Cxy S⁻¹
        m = m_pred + K @ v
        P = _sym(P_pred - K @ S @ K.T)
        return m, P, _gaussian_ll(v, S)

    def core(y):
        wm, wc, scale = _ut_weights(d, alpha, beta, kappa, P0.dtype)
        m1, P1, ll1 = update(m0, P0, y[0], wm, wc, scale)

        def step(carry, obs):
            m, P = carry
            pts = _sigma_points(m, P, scale, jitter)
            fpts = jax.vmap(f)(pts)
            m_pred, P_pred, C = _ut_moments(pts, fpts, wm, wc, m, Q)
            m_u, P_u, ll = update(m_pred, P_pred, obs, wm, wc, scale)
            return (m_u, P_u), (m_u, P_u, m_pred, P_pred, C, ll)

        _, (ms, Ps, mps, Pps, Cs, lls) = lax.scan(step, (m1, P1), y[1:])
        mean = jnp.concatenate([m1[None], ms], axis=0)
        cov = jnp.concatenate([P1[None], Ps], axis=0)
        loglik = ll1 + jnp.sum(lls, axis=0)
        return mean, cov, loglik, mps, Pps, Cs

    return core


def ukf_filter(
    f, h, Q, R, y, m0, P0, *, alpha=1.0, beta=2.0, kappa=0.0, jitter=1e-9
) -> NLSSMBeliefs:
    """Unscented Kalman filtering: moment matching through 2d+1 sigma points
    (scaled unscented transform) — exact for linear ``f``/``h``, third-order
    accurate for smooth nonlinearities, derivative-free."""
    Q, R, m0, P0 = map(jnp.asarray, (Q, R, m0, P0))

    def core(yc):
        mean, cov, ll, *_ = _ukf_pass(f, h, Q, R, m0, P0, alpha, beta, kappa, jitter)(yc)
        return NLSSMBeliefs(mean, cov, ll)

    return _apply_batched(core, y)


def ukf_smooth(
    f, h, Q, R, y, m0, P0, *, alpha=1.0, beta=2.0, kappa=0.0, jitter=1e-9
) -> NLSSMBeliefs:
    """Unscented RTS smoothing: the backward sweep uses the sigma-point
    cross-covariance for the smoother gain (Särkkä 2008)."""
    Q, R, m0, P0 = map(jnp.asarray, (Q, R, m0, P0))

    def core(yc):
        mean, cov, ll, mps, Pps, Cs = _ukf_pass(
            f, h, Q, R, m0, P0, alpha, beta, kappa, jitter
        )(yc)
        mean_s, cov_s, _ = _rts_backward(mean, cov, mps, Pps, Cs)
        return NLSSMBeliefs(mean_s, cov_s, ll)

    return _apply_batched(core, y)
