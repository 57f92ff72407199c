"""Switching linear Gaussian state-space model (SLDS) — IMM filtering.

Extends the chain family (reference chain SSMs:
``/root/reference/test/inference_engine_tests.jl:379-488``) with a discrete
regime variable: ``s_t ~ Π[s_{t-1}]`` selects per-regime dynamics

    x_t = A[s] x_{t-1} + N(0, Q[s]),    y_t = H[s] x_t + N(0, R[s]).

Exact inference is exponential in T (the mixture over regime paths), so the
standard framework answer is assumed-density filtering; we implement the
**interacting-multiple-model (IMM)** filter: carry K Gaussian components +
regime probabilities, moment-match the regime mixture at every step.  This
is the switching analogue of the EKF/UKF projection step — and like
everything here it is one ``lax.scan`` whose step vectorizes over the K
regimes and any number of replicas at once (pure elementwise math).

K = 1 reduces to the exact Kalman filter (tested against
:class:`cortex_tpu.models.LGSSM`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.chains import scalar_kalman_update

__all__ = ["SLDS", "SLDSBeliefs"]


class SLDSBeliefs(NamedTuple):
    """Filtered beliefs of a switching LGSSM.

    ``mean``/``variance``: moment-matched state beliefs, shape ``(..., T)``;
    ``regime_probs``: ``(..., T, K)`` filtered p(s_t | y_{1:t});
    ``loglik``: ``(...,)`` exact-within-ADF data log evidence.
    """

    mean: jax.Array
    variance: jax.Array
    regime_probs: jax.Array
    loglik: jax.Array


@dataclasses.dataclass(frozen=True)
class SLDS:
    """Scalar-state switching LGSSM.

    ``Pi``: ``(K, K)`` regime transition matrix (rows sum to 1, ``Pi[i, j] =
    p(s_t = j | s_{t-1} = i)``); ``A, Q, H, R``: ``(K,)`` per-regime
    coefficients; ``prior``: ``(mean, var)`` on ``x_1``; ``regime_prior``:
    ``(K,)`` p(s_1) (uniform when None).
    """

    Pi: jax.Array
    A: jax.Array
    Q: jax.Array
    H: jax.Array
    R: jax.Array
    prior: Tuple[float, float] = (0.0, 10.0)
    regime_prior: Optional[jax.Array] = None

    def _params(self):
        Pi = jnp.asarray(self.Pi)
        A, Q, H, R = map(jnp.asarray, (self.A, self.Q, self.H, self.R))
        K = Pi.shape[0]
        w0 = (
            jnp.full((K,), 1.0 / K)
            if self.regime_prior is None
            else jnp.asarray(self.regime_prior)
        )
        return Pi, A, Q, H, R, w0

    def filter(self, y: jax.Array) -> SLDSBeliefs:
        """IMM filtering over ``y`` shaped ``(..., T)`` (leading replica
        axes).  Per step: regime mixing (moment matching), per-regime Kalman
        time+measurement update, regime reweighting by the predictive
        likelihoods."""
        Pi, A, Q, H, R, w0 = self._params()
        K = Pi.shape[0]
        y = jnp.asarray(y)
        yT = jnp.moveaxis(y, -1, 0)[..., None]  # (T, ..., 1) broadcast vs K
        batch = yT.shape[1:-1]

        pm = jnp.broadcast_to(jnp.asarray(self.prior[0], y.dtype), batch + (K,))
        pv = jnp.broadcast_to(jnp.asarray(self.prior[1], y.dtype), batch + (K,))
        logw = jnp.broadcast_to(jnp.log(w0), batch + (K,))

        def measurement(m_pred, v_pred, obs, logw_pred):
            m, v, loglik_k = scalar_kalman_update(obs, m_pred, v_pred, H, R)
            joint = logw_pred + loglik_k
            step_ll = jax.nn.logsumexp(joint, axis=-1)
            return m, v, joint - step_ll[..., None], step_ll

        def step(carry, obs):
            m, v, logw = carry
            # Mixing (interacting) step.
            log_joint = logw[..., :, None] + jnp.log(Pi)  # (..., k, j)
            logw_pred = jax.nn.logsumexp(log_joint, axis=-2)  # (..., j)
            mu = jnp.exp(log_joint - logw_pred[..., None, :])  # μ_{k|j}
            m0 = jnp.einsum("...kj,...k->...j", mu, m)
            v0 = jnp.einsum("...kj,...k->...j", mu, v) + jnp.einsum(
                "...kj,...kj->...j", mu, (m[..., :, None] - m0[..., None, :]) ** 2
            )
            # Per-regime time update.
            m_pred = A * m0
            v_pred = A * A * v0 + Q
            m_new, v_new, logw_new, step_ll = measurement(
                m_pred, v_pred, obs, logw_pred
            )
            w = jnp.exp(logw_new)
            mean = jnp.sum(w * m_new, axis=-1)
            var = jnp.sum(w * (v_new + (m_new - mean[..., None]) ** 2), axis=-1)
            return (m_new, v_new, logw_new), (mean, var, w, step_ll)

        # t = 1: no transition — measurement-update the prior directly.
        m1, v1, logw1, ll1 = measurement(pm, pv, yT[0], logw)
        w1 = jnp.exp(logw1)
        mean1 = jnp.sum(w1 * m1, axis=-1)
        var1 = jnp.sum(w1 * (v1 + (m1 - mean1[..., None]) ** 2), axis=-1)

        _, (means, varis, ws, lls) = lax.scan(step, (m1, v1, logw1), yT[1:])
        mean = jnp.moveaxis(jnp.concatenate([mean1[None], means], axis=0), 0, -1)
        var = jnp.moveaxis(jnp.concatenate([var1[None], varis], axis=0), 0, -1)
        probs = jnp.moveaxis(jnp.concatenate([w1[None], ws], axis=0), 0, -2)
        loglik = ll1 + jnp.sum(lls, axis=0)
        return SLDSBeliefs(mean, var, probs, loglik)

    def log_evidence(self, y: jax.Array) -> jax.Array:
        """ADF log p(y_{1:T}) per replica, shape ``y.shape[:-1]``."""
        return self.filter(y).loglik

    def sample(
        self, key: jax.Array, T: int, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Simulate ``(s, x, y)``: regimes ``(batch, T)`` int32, states and
        observations ``(batch, T)``."""
        Pi, A, Q, H, R, w0 = self._params()
        ks, kx0, kw, kv, k0 = jax.random.split(key, 5)
        s0 = jax.random.categorical(k0, jnp.log(w0), shape=batch_shape)
        x0 = self.prior[0] + jnp.sqrt(self.prior[1]) * jax.random.normal(
            kx0, batch_shape
        )

        keys = jax.random.split(ks, T)
        wn = jax.random.normal(kw, (T,) + batch_shape)
        vn = jax.random.normal(kv, (T,) + batch_shape)

        def step(carry, inp):
            s_prev, x_prev, first = carry
            key_t, w_t, v_t = inp
            s = jax.random.categorical(key_t, jnp.log(Pi)[s_prev])
            s = jnp.where(first, s_prev, s)
            x = jnp.where(first, x_prev, A[s] * x_prev + jnp.sqrt(Q[s]) * w_t)
            y_t = H[s] * x + jnp.sqrt(R[s]) * v_t
            return (s, x, jnp.zeros_like(first)), (s, x, y_t)

        first = jnp.ones(batch_shape, dtype=bool)
        _, (ss, xs, ys) = lax.scan(step, (s0, x0, first), (keys, wn, vn))
        return (
            jnp.moveaxis(ss, 0, -1),
            jnp.moveaxis(xs, 0, -1),
            jnp.moveaxis(ys, 0, -1),
        )
