"""Bootstrap particle filter — Monte-Carlo state-space inference.

The north star's third replica axis ("datasets / chains / particle sets"):
particles batch along a leading axis exactly like graph replicas, so a
particle filter is one `lax.scan` over time with `(n_particles, ...)` arrays
— shardable over a mesh like everything else.

Generic over the model: the user supplies ``transition(key, x) -> x'`` and
``log_likelihood(y, x) -> logw`` (both vectorized over the particle axis).
Resampling is systematic (low-variance), implemented as an O(N)
scatter-max + cummax inversion of the weight CDF — fully jittable and
accelerator-friendly (see :func:`systematic_resample`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["ParticleFilterResult", "particle_filter", "systematic_resample"]


class ParticleFilterResult(NamedTuple):
    means: jax.Array  # (T, ...) posterior mean per step
    variances: jax.Array  # (T, ...) posterior variance per step
    log_evidence: jax.Array  # () incremental log p(y_{1:T}) estimate
    ess: jax.Array  # (T,) effective sample size before resampling
    particles: jax.Array  # (N, ...) final particle set


def systematic_resample(key: jax.Array, log_weights: jax.Array) -> jax.Array:
    """Systematic (low-variance) resampling: returns ``(N,)`` int32 indices.

    One uniform offset per sweep; stratified positions ``(j + u)/N`` are
    inverted through the weight CDF.  Batched O(N) inversion: because the
    positions are already sorted, particle ``i``'s children occupy output
    slots ``[C_{i-1}, C_i)`` with ``C_i = ceil(N·cdf_i − u)`` — one
    scatter-max of segment starts followed by a ``cummax`` recovers the
    owner of every slot (a ``searchsorted`` under vmap lowers to a much
    slower loop).
    """
    n = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    u = jax.random.uniform(key)
    C = jnp.clip(jnp.ceil(cdf * n - u), 0, n).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), C[:-1]])
    owners = jnp.zeros((n,), jnp.int32).at[starts].max(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    return jax.lax.cummax(owners)


def particle_filter(
    key: jax.Array,
    y: jax.Array,
    transition: Callable[[jax.Array, jax.Array], jax.Array],
    log_likelihood: Callable[[jax.Array, jax.Array], jax.Array],
    init_particles: jax.Array,
    ess_threshold: float = 0.5,
) -> ParticleFilterResult:
    """Bootstrap particle filter over observations ``y`` of shape ``(T, ...)``.

    ``init_particles``: ``(N, ...)`` initial particle set.  Resampling
    triggers adaptively when the effective sample size drops below
    ``ess_threshold * N``.  Returns per-step moments, the log-evidence
    estimate, and the ESS trace.
    """
    n = init_particles.shape[0]
    yT = jnp.asarray(y)
    n_thresh = ess_threshold * n

    def step(carry, inp):
        particles, log_w, logZ, k = carry
        y_t = inp
        k, k_prop, k_res = jax.random.split(k, 3)

        # Propagate through the transition (bootstrap proposal).
        particles = transition(k_prop, particles)
        # Weight update + evidence increment.
        log_l = log_likelihood(y_t, particles)
        log_w = log_w + log_l
        logZ = logZ + jax.nn.logsumexp(log_w) - jax.nn.logsumexp(log_w - log_l)

        w = jax.nn.softmax(log_w)
        ess = 1.0 / jnp.sum(w**2)
        mean = jnp.sum(w[:, None] * jnp.atleast_2d(particles.reshape(n, -1)), axis=0)
        var = jnp.sum(
            w[:, None] * (particles.reshape(n, -1) - mean) ** 2, axis=0
        )

        # Adaptive systematic resampling.
        idx = systematic_resample(k_res, log_w)
        do_resample = ess < n_thresh
        particles = jnp.where(
            do_resample,
            jnp.take(particles, idx, axis=0),
            particles,
        )
        log_w = jnp.where(do_resample, jnp.zeros_like(log_w), log_w)

        return (particles, log_w, logZ, k), (mean, var, ess)

    init = (
        init_particles,
        jnp.zeros(n),
        jnp.asarray(0.0),
        key,
    )
    (particles, log_w, logZ, _), (means, variances, ess) = lax.scan(step, init, yT)
    shape_tail = init_particles.shape[1:] or (1,)
    return ParticleFilterResult(
        means.reshape((yT.shape[0],) + shape_tail).squeeze(),
        variances.reshape((yT.shape[0],) + shape_tail).squeeze(),
        logZ,
        ess,
        particles,
    )
