"""Rao-Blackwellized particle filter for switching LGSSMs.

The marginalized complement of :class:`cortex_tpu.models.SLDS`'s IMM filter:
sample only the discrete regime path per particle and run an **exact scalar
Kalman filter conditioned on it** — the continuous state is integrated out
analytically, so Monte-Carlo variance lives only on the K-ary regime chain.
With K=1 there is no randomness at all and the log-evidence estimate equals
the exact Kalman evidence (tested).

Shape: particles are just another batch axis; one ``lax.scan`` over time
carries ``(N,)`` regime indices + Kalman moments + log-weights, with adaptive
systematic resampling (shared with :mod:`cortex_tpu.models.particle`).
Per-regime parameters are gathered with ``A[s]``-style indexing — K tiny
lookup tables, no branching.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.chains import scalar_kalman_update
from .particle import systematic_resample
from .slds import SLDS

__all__ = ["RBPFResult", "rbpf_filter"]


class RBPFResult(NamedTuple):
    """``regime_probs``: ``(T, K)`` weighted-particle regime posterior;
    ``mean``/``variance``: ``(T,)`` Rao-Blackwellized state beliefs;
    ``log_evidence``: ``()`` marginal-likelihood estimate;
    ``ess``: ``(T,)`` effective sample size before resampling."""

    regime_probs: jax.Array
    mean: jax.Array
    variance: jax.Array
    log_evidence: jax.Array
    ess: jax.Array


def rbpf_filter(
    key: jax.Array,
    model: SLDS,
    y: jax.Array,
    n_particles: int = 512,
    ess_threshold: float = 0.5,
) -> RBPFResult:
    """Filter one observation sequence ``y`` of shape ``(T,)``; vmap over a
    leading key/data axis for replicas.  Resampling triggers when the ESS
    drops below ``ess_threshold * n_particles``."""
    Pi, A, Q, H, R, w0 = model._params()
    K = Pi.shape[0]
    yT = jnp.asarray(y)
    N = n_particles
    pm, pv = (jnp.asarray(v, yT.dtype) for v in model.prior)
    log_pi = jnp.log(Pi)

    def kalman_update(s, m_pred, v_pred, obs):
        return scalar_kalman_update(obs, m_pred, v_pred, H[s], R[s])

    def moments(logw, s, m, v):
        w = jax.nn.softmax(logw)
        probs = jnp.zeros((K,), yT.dtype).at[s].add(w)
        mean = jnp.sum(w * m)
        var = jnp.sum(w * (v + (m - mean) ** 2))
        ess = 1.0 / jnp.sum(w**2)
        return probs, mean, var, ess

    k0, kscan = jax.random.split(key)
    s1 = jax.random.categorical(k0, jnp.log(w0), shape=(N,))
    m1, v1, ll1 = kalman_update(
        s1, jnp.full((N,), pm), jnp.full((N,), pv), yT[0]
    )
    logZ1 = jax.nn.logsumexp(ll1) - jnp.log(float(N))
    probs1, mean1, var1, ess1 = moments(ll1, s1, m1, v1)

    def step(carry, inp):
        s, m, v, logw, logZ = carry
        obs, k_t = inp
        k_prop, k_res = jax.random.split(k_t)
        # Propose regimes from the prior chain (bootstrap proposal).
        s_new = jax.random.categorical(k_prop, log_pi[s], axis=-1)
        m_pred = A[s_new] * m
        v_pred = A[s_new] * A[s_new] * v + Q[s_new]
        m_new, v_new, ll = kalman_update(s_new, m_pred, v_pred, obs)
        logw_new = logw + ll
        logZ = logZ + jax.nn.logsumexp(logw_new) - jax.nn.logsumexp(logw)
        probs, mean, var, ess = moments(logw_new, s_new, m_new, v_new)
        # Adaptive systematic resampling.
        idx = systematic_resample(k_res, logw_new)
        do = ess < ess_threshold * N
        s_out = jnp.where(do, s_new[idx], s_new)
        m_out = jnp.where(do, m_new[idx], m_new)
        v_out = jnp.where(do, v_new[idx], v_new)
        logw_out = jnp.where(do, jnp.zeros_like(logw_new), logw_new)
        return (s_out, m_out, v_out, logw_out, logZ), (probs, mean, var, ess)

    keys = jax.random.split(kscan, yT.shape[0] - 1)
    init = (s1, m1, v1, ll1 - jax.nn.logsumexp(ll1), logZ1)
    (_, _, _, _, logZ), (probs, means, varis, esses) = lax.scan(
        step, init, (yT[1:], keys)
    )
    return RBPFResult(
        jnp.concatenate([probs1[None], probs], axis=0),
        jnp.concatenate([mean1[None], means], axis=0),
        jnp.concatenate([var1[None], varis], axis=0),
        logZ,
        jnp.concatenate([ess1[None], esses], axis=0),
    )
