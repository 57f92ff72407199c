"""Chain message passing (Kalman smoothing) as XLA scan programs.

The reference computes LGSSM smoothing by dynamic message passing over a
chain factor graph (``/root/reference/test/inference_engine_tests.jl:379-488``):
forward/backward sweeps of Gaussian messages, marginal = product of the
inbound messages.  Compiled, the chain structure is static, so the whole sweep
compiles to scans:

- :func:`lgssm_smooth_scan` — ``lax.scan`` forward + backward message
  recursions, *batched over replicas* in the leading axes.  One scan step
  updates every replica's message at once; the time axis is sequential.
- :func:`lgssm_smooth_assoc` — time-parallel formulation via
  ``lax.associative_scan`` (the parallel Kalman filter/smoother of Särkkä &
  García-Fernández, 2020): O(log T) depth, for long chains / few replicas.

Both return identical Belief-Propagation marginals: the posterior mean/variance
of every state given all observations (Kalman/RTS-equivalent), matching the
reference's sum-product semantics with the chain's messages:

    marginal_t = obs_message_t · forward_message_t · backward_message_t

Model (scalar state, per batch element):

    x_t = A x_{t-1} + N(0, Q),    y_t = H x_t + N(0, R)

With no explicit prior on ``x_1`` (the reference chain has none): the first
forward "filtered" belief is just the first observation message
``N(y_1/H, R/H²)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "lgssm_smooth_scan",
    "lgssm_smooth_assoc",
    "lgssm_smooth_matmul",
    "lgssm_smoother_operator",
    "lgssm_messages_scan",
    "scalar_kalman_update",
]


def scalar_kalman_update(obs, m_pred, v_pred, H=1.0, R=1.0):
    """Scalar Kalman measurement update, elementwise over any batch shape.

    The one canonical implementation of the innovation/gain/log-density
    triple used by the LGSSM evidence, EM, the IMM (SLDS) filter and the
    RBPF — returns ``(m_filt, v_filt, loglik)`` with
    ``loglik = log N(obs; H·m_pred, H²·v_pred + R)``.
    """
    s = H * H * v_pred + R
    ll = -0.5 * (jnp.log(2.0 * jnp.pi * s) + (obs - H * m_pred) ** 2 / s)
    g = v_pred * H / s
    m = m_pred + g * (obs - H * m_pred)
    v = v_pred - g * H * v_pred
    return m, v, ll


class ChainMarginals(NamedTuple):
    """Posterior marginals of each state: arrays shaped like ``y``."""

    mean: jax.Array
    variance: jax.Array


def _obs_message(y, H, R):
    """Information-form observation message into x_t: xi = H y / R, w = H²/R.

    Missing observations (NaN) carry zero information: xi = w = 0, which the
    division-safe message projections below propagate exactly (a missing
    step is pure prediction) — no imputation, no variance inflation hacks.
    """
    observed = ~jnp.isnan(y)
    y = jnp.where(observed, y, 0.0)
    xi = jnp.where(observed, H * y / R, 0.0)
    w = jnp.where(observed, jnp.asarray((H * H) / R, xi.dtype), 0.0)
    return xi, jnp.broadcast_to(w, xi.shape)


def lgssm_smooth_scan(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> ChainMarginals:
    """BP smoothing of a scalar LGSSM chain via two ``lax.scan`` passes.

    Parameters
    ----------
    y:
        Observations, shape ``(..., T)``; leading axes are replica batches.
    A, Q, H, R:
        Transition/observation coefficients (scalars or broadcastable arrays).
    prior:
        Optional ``(mean, variance)`` prior message on ``x_1``; ``None``
        mirrors the reference chain (no prior factor on the first state).

    Returns
    -------
    ChainMarginals with ``mean``/``variance`` of shape ``(..., T)``.
    """
    y = jnp.asarray(y)
    yT = jnp.moveaxis(y, -1, 0)  # (T, ...batch)
    xi_obs, w_obs = _obs_message(yT, H, R)
    return _info_form_smooth(xi_obs, w_obs, A, Q, prior)


def _info_form_smooth(xi_obs, w_obs, A, Q, prior):
    """Forward/backward sweep over information-form observation messages
    ``(T, ...batch)`` — shared by the Gaussian path and the robust
    (per-step reweighted) path."""
    if prior is not None:
        pm, pv = prior
        xi0 = xi_obs[0] + pm / pv
        w0 = w_obs[0] + 1.0 / pv
    else:
        xi0, w0 = xi_obs[0], w_obs[0]

    # Forward pass: carry the filtered belief (product of obs message and
    # forward message); emit the forward *message* into the next state.
    def fwd_step(carry, obs):
        xi_f, w_f = carry  # filtered belief of x_{t-1}
        xi_o, w_o = obs  # obs message of x_t
        # Project through transition x_t = A x_{t-1} + N(0,Q), in the
        # division-safe rational form (valid at w_f = 0, the zero-information
        # belief a run of missing observations produces):
        #   w_msg = w / (A² + Q w),  xi_msg = A xi / (A² + Q w).
        denom = A * A + Q * w_f
        xi_msg = A * xi_f / denom
        w_msg = w_f / denom
        new_xi = xi_msg + xi_o
        new_w = w_msg + w_o
        return (new_xi, new_w), (xi_msg, w_msg)

    (_, _), (xi_fwd, w_fwd) = lax.scan(
        fwd_step, (xi0, w0), (xi_obs[1:], w_obs[1:])
    )
    # Forward message into x_1 is "no message" (zero information).
    zero = jnp.zeros_like(xi_obs[0])
    xi_fwd = jnp.concatenate([zero[None], xi_fwd], axis=0)
    w_fwd = jnp.concatenate([zero[None], w_fwd], axis=0)

    # Backward pass: carry the product (obs_t · backward message of x_t);
    # emit the backward message into x_{t-1}.
    def bwd_step(carry, obs):
        xi_b, w_b = carry
        xi_o, w_o = obs
        # Project back through the transition x_{t-1} = (x_t - noise)/A, in
        # the division-safe rational form (valid at w_b = 0):
        #   w_msg = A² w / (1 + Q w),  xi_msg = A xi / (1 + Q w).
        denom = 1.0 + Q * w_b
        xi_msg = A * xi_b / denom
        w_msg = A * A * w_b / denom
        new_xi = xi_msg + xi_o
        new_w = w_msg + w_o
        return (new_xi, new_w), (xi_msg, w_msg)

    (_, _), (xi_bwd_rev, w_bwd_rev) = lax.scan(
        bwd_step,
        (xi_obs[-1], w_obs[-1]),
        (xi_obs[:-1][::-1], w_obs[:-1][::-1]),
    )
    xi_bwd = jnp.concatenate([xi_bwd_rev[::-1], zero[None]], axis=0)
    w_bwd = jnp.concatenate([w_bwd_rev[::-1], zero[None]], axis=0)

    # Marginal_t = obs_t · fwd_t · bwd_t (+ prior on t=1 when given).
    xi_m = xi_obs + xi_fwd + xi_bwd
    w_m = w_obs + w_fwd + w_bwd
    if prior is not None:
        pm, pv = prior
        xi_m = xi_m.at[0].add(pm / pv)
        w_m = w_m.at[0].add(1.0 / pv)

    mean = jnp.moveaxis(xi_m / w_m, 0, -1)
    variance = jnp.moveaxis(1.0 / w_m, 0, -1)
    return ChainMarginals(mean, variance)


# -- Matmul formulation -------------------------------------------------------
#
# The smoother is an *affine* operator in the observations: the marginal
# precisions w_m depend only on (A, Q, H, R, T) — not on the data — and the
# information means xi_m are linear in y.  So the entire R-replica sweep is
#
#     mean = y @ S + c,     variance = v   (one data-independent row)
#
# with S the (T, T) smoother impulse-response matrix.  This is the dense
# linear-algebra lowering of the reference's whole chain sweep
# (/root/reference/src/inference_engine.jl:559-632 over the chain of
# test/inference_engine_tests.jl:379-488): a single matmul replaces
# 3T-2 per-signal message updates per replica, with zero intermediate HBM
# traffic and no transposes.  FLOPs are 2·R·T² — at T=100 still firmly
# bandwidth-bound, i.e. speed-of-light for this memory footprint.


def lgssm_smoother_operator(
    T: int,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Tuple[jax.Array, jax.Array]] = None,
    dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Precompute the affine smoother ``(S, c, v)``: ``mean = y @ S + c``,
    ``variance = v`` (shape ``(T,)``, data-independent).

    Built by smoothing the T×T identity through :func:`lgssm_smooth_scan`
    (the smoother's impulse response), so it is exact for any (A, Q, H, R)
    and inherits the prior convention.  Cost: one T-step scan over T
    replicas, once per (model, T).
    """
    eye = jnp.eye(T, dtype=dtype)
    base = lgssm_smooth_scan(jnp.zeros((T,), dtype), A, Q, H, R, prior)
    cols = lgssm_smooth_scan(eye, A, Q, H, R, prior)
    # cols.mean[s, t] = d mean_t / d y_s; base.mean is the prior-only offset.
    S = cols.mean - base.mean[None, :]
    return S, base.mean, base.variance


def lgssm_smooth_matmul(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Tuple[jax.Array, jax.Array]] = None,
    operator: Optional[Tuple[jax.Array, jax.Array, jax.Array]] = None,
) -> ChainMarginals:
    """BP smoothing as ONE matmul: ``mean = y @ S + c``.

    Identical marginals to :func:`lgssm_smooth_scan` (up to matmul rounding;
    computed at ``Precision.HIGHEST``).  Requires dense observations — a NaN
    (missing) entry poisons that replica's outputs loudly; use the scan path
    for missing data.  Pass a precomputed ``operator`` (from
    :func:`lgssm_smoother_operator`) to amortize the operator build across
    calls/jits.
    """
    y = jnp.asarray(y)
    if operator is None:
        operator = lgssm_smoother_operator(y.shape[-1], A, Q, H, R, prior, y.dtype)
    S, offset, var_row = operator
    mean = (
        jnp.matmul(y, S.astype(y.dtype), precision=lax.Precision.HIGHEST)
        + offset.astype(y.dtype)
    )
    variance = jnp.broadcast_to(var_row.astype(y.dtype), mean.shape)
    return ChainMarginals(mean, variance)


def lgssm_messages_scan(y, A=1.0, Q=1.0, H=1.0, R=1.0):
    """Return the forward and backward chain *messages* in information form,
    shape ``(..., T)`` each — the scan analogue of reading individual
    ``MessageToVariable`` signals off the dynamic engine."""
    y = jnp.asarray(y)
    marg = lgssm_smooth_scan(y, A, Q, H, R)
    # Recompute components (cheap, fused by XLA when jitted together).
    yT = jnp.moveaxis(y, -1, 0)
    xi_obs, w_obs = _obs_message(yT, H, R)
    xi_m = jnp.moveaxis(marg.mean / marg.variance, -1, 0)
    w_m = jnp.moveaxis(1.0 / marg.variance, -1, 0)
    return {
        "obs": (jnp.moveaxis(xi_obs, 0, -1), jnp.moveaxis(w_obs, 0, -1)),
        "marginal": (jnp.moveaxis(xi_m, 0, -1), jnp.moveaxis(w_m, 0, -1)),
    }


# -- Time-parallel (associative scan) formulation ---------------------------
#
# Parallel Kalman filtering/smoothing (Särkkä & García-Fernández 2020,
# arXiv:1905.13002): filtering is an associative combination of per-step
# conditional-Gaussian elements (A, b, C, eta, J); smoothing of (E, g, L).
# O(log T) depth on the time axis.


class _FilterElem(NamedTuple):
    A: jax.Array
    b: jax.Array
    C: jax.Array
    eta: jax.Array
    J: jax.Array


def _filter_combine(e1: _FilterElem, e2: _FilterElem) -> _FilterElem:
    """Scalar-state specialization of the paper's eq. (10)-(11)."""
    denom = 1.0 + e1.C * e2.J
    A = e2.A * e1.A / denom
    b = e2.A * (e1.b + e1.C * e2.eta) / denom + e2.b
    C = e2.A * e2.A * e1.C / denom + e2.C
    eta = e1.A * (e2.eta - e2.J * e1.b) / denom + e1.eta
    J = e1.A * e1.A * e2.J / denom + e1.J
    return _FilterElem(A, b, C, eta, J)


class _SmootherElem(NamedTuple):
    E: jax.Array
    g: jax.Array
    L: jax.Array


def _smoother_combine(e1: _SmootherElem, e2: _SmootherElem) -> _SmootherElem:
    """Reverse-direction combination (paper eq. (21)): elem1 closer to t=T."""
    return _SmootherElem(
        e2.E * e1.E, e2.E * e1.g + e2.g, e2.E * e2.E * e1.L + e2.L
    )


def lgssm_smooth_assoc(
    y: jax.Array,
    A: float = 1.0,
    Q: float = 1.0,
    H: float = 1.0,
    R: float = 1.0,
    prior: Optional[Tuple[jax.Array, jax.Array]] = None,
) -> ChainMarginals:
    """Time-parallel BP smoothing via ``lax.associative_scan``.

    Same inputs/outputs as :func:`lgssm_smooth_scan`; O(log T) depth on the
    time axis — the time-parallel formulation of the reference's sequential
    forward/backward sweep ordering (``src/inference_engine.jl:575-607``).
    """
    y = jnp.asarray(y)
    observed = ~jnp.isnan(y)
    y = jnp.where(observed, y, 0.0)
    obsT = jnp.moveaxis(observed, -1, 0)
    yT = jnp.moveaxis(y, -1, 0)  # (T, ...)
    batch_shape = yT.shape[1:]

    if prior is not None:
        m0, P0 = prior
        m0 = jnp.broadcast_to(jnp.asarray(m0, y.dtype), batch_shape)
        P0 = jnp.broadcast_to(jnp.asarray(P0, y.dtype), batch_shape)
    else:
        # No prior factor: emulate with the first filtered belief equal to the
        # first observation message alone (infinite prior variance limit).
        m0 = yT[0] / H
        P0 = jnp.broadcast_to(jnp.asarray(R, y.dtype) / (H * H), batch_shape)

    # First filtering element: filtered belief of x_1.  A missing first
    # observation falls back to the prior alone (a prior is required for a
    # missing y[0]; the no-prior convention needs y[0] observed).
    if prior is not None:
        S1 = H * P0 * H + R
        K1 = jnp.where(obsT[0], P0 * H / S1, 0.0)
        b1 = m0 + K1 * (yT[0] - H * m0)
        C1 = P0 - K1 * H * P0
    else:
        b1, C1 = m0, P0
    zeros = jnp.zeros_like(b1)
    elem1 = _FilterElem(zeros, b1, C1, zeros, zeros)

    # Generic elements for t >= 2; a missing step's element is the pure
    # prediction (A, 0, Q, 0, 0).
    yrest = yT[1:]
    orest = obsT[1:]
    S = H * Q * H + R
    K = Q * H / S
    A_e = jnp.where(orest, jnp.asarray((1.0 - K * H) * A, y.dtype), A)
    b_e = jnp.where(orest, K * yrest, 0.0)
    C_e = jnp.where(orest, jnp.asarray((1.0 - K * H) * Q, y.dtype), Q)
    eta_e = jnp.where(orest, A * H * yrest / S, 0.0)
    J_e = jnp.where(orest, jnp.asarray(A * H * H * A / S, y.dtype), 0.0)
    A_e = jnp.broadcast_to(A_e, yrest.shape)
    C_e = jnp.broadcast_to(C_e, yrest.shape)
    J_e = jnp.broadcast_to(J_e, yrest.shape)

    elems = _FilterElem(
        jnp.concatenate([elem1.A[None], A_e], axis=0),
        jnp.concatenate([elem1.b[None], b_e], axis=0),
        jnp.concatenate([elem1.C[None], C_e], axis=0),
        jnp.concatenate([elem1.eta[None], eta_e], axis=0),
        jnp.concatenate([elem1.J[None], J_e], axis=0),
    )

    filtered = lax.associative_scan(_filter_combine, elems, axis=0)
    fm, fP = filtered.b, filtered.C  # filtered means/vars, shape (T, ...)

    # Smoothing elements (reverse associative scan).
    # For t < T:  E = C_f A / (A C_f A + Q);  g = m_f - E A m_f;
    #             L = C_f - E A C_f.
    Pp = A * A * fP[:-1] + Q  # predicted variance, shape (T-1, ...)
    E = fP[:-1] * A / Pp
    g = fm[:-1] - E * A * fm[:-1]
    L = fP[:-1] - E * A * fP[:-1]
    E_T = jnp.zeros_like(fm[0])
    g_T = fm[-1]
    L_T = fP[-1]
    selems = _SmootherElem(
        jnp.concatenate([E, E_T[None]], axis=0),
        jnp.concatenate([g, g_T[None]], axis=0),
        jnp.concatenate([L, L_T[None]], axis=0),
    )
    smoothed = lax.associative_scan(_smoother_combine, selems, axis=0, reverse=True)
    mean = jnp.moveaxis(smoothed.g, 0, -1)
    variance = jnp.moveaxis(smoothed.L, 0, -1)
    return ChainMarginals(mean, variance)
