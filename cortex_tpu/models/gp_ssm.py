"""State-space (Markovian) Gaussian processes: Matérn GPs as LGSSM scans.

A 1-D-input GP with a Matérn kernel is *exactly* equivalent to a linear
SDE observed at the input locations (Hartikainen & Särkkä 2010), so exact
GP regression — O(n³) dense Cholesky in :mod:`cortex_tpu.models.gp` —
lowers to Kalman filtering/smoothing: **O(n) work, O(log n) depth** on the
time axis, with per-step state dimension 1–3.  This is the same lowering
the framework applies everywhere (chain factor graph → scan; cf. the
reference's chain models, ``/root/reference/test/inference_engine_tests.jl:379-488``):
the GP *is* a chain factor graph once its kernel is Markovian.

Notes: all per-step quantities are closed-form (no ``expm``:
the Matérn transition matrices have analytic entries), stacked as
``(T, d, d)`` arrays and consumed by one ``lax.scan``; irregular sampling
is free (per-step Δt).  The log marginal likelihood is differentiable in
the hyperparameters — ``fit_gpssm_ml`` runs Adam on the prediction-error
decomposition, scaling GP hyperparameter learning to millions of points.

Exactness is pinned by parity tests against the dense-Cholesky GP.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..dists.gaussian import _spd_solve_logdet

__all__ = ["GPSSM", "GPSSMPosterior", "fit_gpssm_ml", "matern_state_space"]


def matern_state_space(kernel: str, lengthscale, variance, dts: jax.Array):
    """Per-step transition matrices for a Matérn SDE on gaps ``dts`` (T,).

    Returns ``(A, Q, H, P_inf)`` with ``A, Q: (T, d, d)``, ``H: (d,)``,
    ``P_inf: (d, d)`` — all analytic (``A = expm(F dt)`` in closed form;
    ``Q = P_inf − A P_inf Aᵀ`` by stationarity).
    """
    dts = jnp.asarray(dts)
    ell = jnp.asarray(lengthscale, dts.dtype)
    var = jnp.asarray(variance, dts.dtype)

    if kernel == "matern12":
        lam = 1.0 / ell
        A = jnp.exp(-lam * dts)[:, None, None]
        P_inf = var[None, None] * jnp.ones((1, 1), dts.dtype)
        H = jnp.ones((1,), dts.dtype)
    elif kernel == "matern32":
        lam = jnp.sqrt(3.0) / ell
        e = jnp.exp(-lam * dts)
        # expm of [[0,1],[-λ²,-2λ]] dt (defective eigenvalue -λ, analytic):
        A = e[:, None, None] * jnp.stack(
            [
                jnp.stack([1.0 + lam * dts, dts], axis=-1),
                jnp.stack([-(lam**2) * dts, 1.0 - lam * dts], axis=-1),
            ],
            axis=-2,
        )
        P_inf = jnp.array([[1.0, 0.0], [0.0, 0.0]], dts.dtype) * var
        P_inf = P_inf.at[1, 1].set(var * lam**2)
        H = jnp.array([1.0, 0.0], dts.dtype)
    elif kernel == "matern52":
        lam = jnp.sqrt(5.0) / ell
        e = jnp.exp(-lam * dts)
        t = dts
        # expm of the companion form of (d/dt + λ)³ — triple eigenvalue -λ:
        # expm(F t) = e^{-λt} [ I + (F+λI) t + (F+λI)² t²/2 ]
        r0c = jnp.stack(
            [
                1.0 + lam * t + 0.5 * lam**2 * t**2,
                t + lam * t**2,
                0.5 * t**2,
            ],
            axis=-1,
        )
        r1c = jnp.stack(
            [
                -0.5 * lam**3 * t**2,
                1.0 + lam * t - lam**2 * t**2,
                t - 0.5 * lam * t**2,
            ],
            axis=-1,
        )
        r2c = jnp.stack(
            [
                0.5 * lam**4 * t**2 - lam**3 * t,
                lam**3 * t**2 - 3.0 * lam**2 * t,
                1.0 - 2.0 * lam * t + 0.5 * lam**2 * t**2,
            ],
            axis=-1,
        )
        A = e[:, None, None] * jnp.stack([r0c, r1c, r2c], axis=-2)
        kappa = lam**2 / 3.0
        P_inf = var * jnp.array(
            [
                [1.0, 0.0, -kappa],
                [0.0, kappa, 0.0],
                [-kappa, 0.0, lam**4],
            ],
            dts.dtype,
        )
        H = jnp.array([1.0, 0.0, 0.0], dts.dtype)
    else:
        raise ValueError(f"unknown Markovian kernel {kernel!r}")

    Q = P_inf[None] - A @ P_inf[None] @ jnp.swapaxes(A, -1, -2)
    # Symmetrize against float roundoff (Q must stay PSD for the filter).
    Q = 0.5 * (Q + jnp.swapaxes(Q, -1, -2))
    return A, Q, H, P_inf


class GPSSMPosterior(NamedTuple):
    mean: jax.Array  # (T,) posterior mean of f at the inputs
    variance: jax.Array  # (T,) posterior variance of f
    log_marginal_likelihood: jax.Array  # ()


@dataclasses.dataclass(frozen=True)
class GPSSM:
    """Markovian GP regression: ``f ~ GP(0, k)``, ``y = f(t) + N(0, noise)``.

    ``kernel`` ∈ {"matern12", "matern32", "matern52"}.  Inputs ``t`` must be
    sorted ascending (1-D inputs only — that is what makes the GP a chain).
    """

    kernel: str = "matern32"
    lengthscale: float = 1.0
    variance: float = 1.0
    noise: float = 0.1

    def posterior(self, t: jax.Array, y: jax.Array) -> GPSSMPosterior:
        """Exact GP posterior at the training inputs + log evidence,
        via Kalman filter + RTS smoother over the Matérn SDE."""
        t = jnp.asarray(t)
        y = jnp.asarray(y)
        # Host-side cheap check (numpy, so it never enters a jit trace);
        # abstract/traced inputs skip it — the caller owns the invariant then.
        if not isinstance(t, jax.core.Tracer) and np.any(
            np.diff(np.asarray(t)) < 0
        ):
            raise ValueError(
                "GPSSM inputs t must be sorted ascending: negative gaps make "
                "exp(-λ·dt) blow up and the chain filter silently wrong."
            )
        dts = jnp.diff(t)
        A, Q, H, P_inf = matern_state_space(
            self.kernel, self.lengthscale, self.variance, dts
        )
        d = H.shape[0]
        noise = jnp.asarray(self.noise, t.dtype)

        def kalman_update(m_pred, P_pred, obs):
            s = H @ P_pred @ H + noise
            k = (P_pred @ H) / s
            innov = obs - H @ m_pred
            m = m_pred + k * innov
            P = P_pred - jnp.outer(k, H @ P_pred)
            ll = -0.5 * (jnp.log(2.0 * jnp.pi * s) + innov**2 / s)
            return m, 0.5 * (P + P.T), ll

        m0, P0, ll0 = kalman_update(jnp.zeros((d,), t.dtype), P_inf, y[0])

        def fstep(carry, inp):
            m, P = carry
            A_t, Q_t, obs = inp
            m_pred = A_t @ m
            P_pred = A_t @ P @ A_t.T + Q_t
            m_f, P_f, ll = kalman_update(m_pred, P_pred, obs)
            return (m_f, P_f), (m_f, P_f, m_pred, P_pred, ll)

        (_, _), (ms, Ps, mps, Pps, lls) = lax.scan(
            fstep, (m0, P0), (A, Q, y[1:])
        )
        ms = jnp.concatenate([m0[None], ms], axis=0)  # filtered means (T, d)
        Ps = jnp.concatenate([P0[None], Ps], axis=0)
        lml = ll0 + lls.sum()

        # RTS backward: G_t = P_t A_{t+1}ᵀ P_pred_{t+1}⁻¹.
        def bstep(carry, inp):
            m_s, P_s = carry
            m_f, P_f, A_n, m_pred_n, P_pred_n = inp
            # SPD solve without the per-step LU custom call.
            G = _spd_solve_logdet(P_pred_n, (P_f @ A_n.T).T)[0].T
            m_new = m_f + G @ (m_s - m_pred_n)
            P_new = P_f + G @ (P_s - P_pred_n) @ G.T
            P_new = 0.5 * (P_new + P_new.T)
            return (m_new, P_new), (m_new, P_new)

        init = (ms[-1], Ps[-1])
        (_, _), (sm_rev, sP_rev) = lax.scan(
            bstep,
            init,
            (ms[:-1][::-1], Ps[:-1][::-1], A[::-1], mps[::-1], Pps[::-1]),
        )
        sm = jnp.concatenate([sm_rev[::-1], ms[-1][None]], axis=0)
        sP = jnp.concatenate([sP_rev[::-1], Ps[-1][None]], axis=0)

        mean = sm @ H
        variance = jnp.einsum("i,tij,j->t", H, sP, H)
        return GPSSMPosterior(mean, variance, lml)

    def log_marginal_likelihood(self, t, y) -> jax.Array:
        return self.posterior(t, y).log_marginal_likelihood


def fit_gpssm_ml(
    t: jax.Array,
    y: jax.Array,
    kernel: str = "matern32",
    n_iters: int = 200,
    learning_rate: float = 0.05,
    init: Optional[Tuple[float, float, float]] = None,
) -> Tuple[GPSSM, jax.Array]:
    """ML-II hyperparameters by Adam on the O(n) negative log evidence.

    Returns the fitted model and the per-iteration NLL trace.
    """
    import optax

    t = jnp.asarray(t)
    y = jnp.asarray(y)
    if np.any(np.diff(np.asarray(t)) < 0):
        raise ValueError("fit_gpssm_ml requires t sorted ascending")
    if init is None:
        span = (t[-1] - t[0]) / max(t.shape[0] - 1, 1)
        init = (float(span * 10.0), float(jnp.var(y)), float(jnp.var(y)) * 0.1)
    params0 = jnp.log(jnp.asarray(init, t.dtype))

    def nll(log_params):
        ell, var, noise = jnp.exp(log_params)
        model = GPSSM(kernel=kernel, lengthscale=ell, variance=var, noise=noise)
        return -model.log_marginal_likelihood(t, y)

    opt = optax.adam(learning_rate)

    def step(carry, _):
        params, state = carry
        loss, g = jax.value_and_grad(nll)(params)
        updates, state = opt.update(g, state, params)
        return (optax.apply_updates(params, updates), state), loss

    (params, _), losses = lax.scan(
        step, (params0, opt.init(params0)), None, length=n_iters
    )
    ell, var, noise = (float(v) for v in jnp.exp(params))
    return GPSSM(kernel=kernel, lengthscale=ell, variance=var, noise=noise), losses
