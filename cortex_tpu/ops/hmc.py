"""Hamiltonian Monte Carlo over pytree positions — gradient-based sampling.

The sampling-based complement to the framework's message-passing families
(BP/VMP/EP/EM/SMC): exact-asymptotics posterior sampling for non-conjugate
parameters where no closed-form message exists.  The reference has no
sampling machinery at all (its rules are closed-form,
`/root/reference/src/inference_engine.jl:331-477`); here every model's log
density is already a pure differentiable JAX function, so HMC needs nothing
but ``jax.grad``.

Shape: one chain is a ``lax.scan`` of leapfrog integrations (pure
elementwise math + the user's log-density, typically matmul-bound); many
chains are one ``vmap`` — run 64–1024 chains per chip and spend wall-clock
on independent mixing instead of serial chain length.  Warmup adapts the
step size by dual averaging (Nesterov/Hoffman-Gelman) and a diagonal mass
matrix from the warmup trajectory (Welford), then freezes both.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["HMCResult", "hmc_sample"]


class HMCResult(NamedTuple):
    """``samples``: pytree with leading ``(n_samples,)`` axis (post-warmup);
    ``log_density``: ``(n_samples,)``; ``accept_rate``: scalar mean
    post-warmup acceptance; ``step_size``: adapted value."""

    samples: Any
    log_density: jax.Array
    accept_rate: jax.Array
    step_size: jax.Array


def _flatten(pos):
    leaves, treedef = jax.tree_util.tree_flatten(pos)
    shapes = [l.shape for l in leaves]
    sizes = [l.size for l in leaves]
    flat = jnp.concatenate([jnp.ravel(l) for l in leaves]) if leaves else jnp.zeros(0)
    def unflatten(x):
        out, o = [], 0
        for s, n in zip(shapes, sizes):
            out.append(x[o : o + n].reshape(s))
            o += n
        return jax.tree_util.tree_unflatten(treedef, out)
    return flat, unflatten


def hmc_sample(
    key: jax.Array,
    log_density: Callable,
    init_position: Any,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 32,
    target_accept: float = 0.8,
    init_step_size: float = 0.1,
) -> HMCResult:
    """Sample from ``exp(log_density(position))``; ``position`` is any pytree
    of float arrays.  Returns post-warmup draws.  For multiple chains, vmap
    over ``key`` (and optionally ``init_position``)."""
    pos0_tree = init_position
    flat0, unflatten = _flatten(
        jax.tree_util.tree_map(jnp.asarray, pos0_tree)
    )
    d = flat0.shape[0]

    def logp(x):
        return jnp.asarray(log_density(unflatten(x)))

    grad_logp = jax.grad(logp)

    def leapfrog(x, p, eps, inv_mass):
        def body(carry, _):
            x, p = carry
            p = p + 0.5 * eps * grad_logp(x)
            x = x + eps * inv_mass * p
            p = p + 0.5 * eps * grad_logp(x)
            return (x, p), None
        (x, p), _ = lax.scan(body, (x, p), None, length=n_leapfrog)
        return x, p

    def kinetic(p, inv_mass):
        return 0.5 * jnp.sum(p * p * inv_mass)

    def hmc_step(carry, key_t, eps, inv_mass, sqrt_mass):
        x, lp = carry
        k_mom, k_acc, k_jit = jax.random.split(key_t, 3)
        # Jitter the step size ±20% per iteration: fixed-length trajectories
        # on near-Gaussian targets resonate with the period and produce
        # strongly antithetic chains otherwise.
        eps = eps * jax.random.uniform(k_jit, minval=0.8, maxval=1.2)
        p0 = sqrt_mass * jax.random.normal(k_mom, (d,), flat0.dtype)
        x_new, p_new = leapfrog(x, p0, eps, inv_mass)
        lp_new = logp(x_new)
        log_alpha = (lp_new - kinetic(p_new, inv_mass)) - (lp - kinetic(p0, inv_mass))
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = jnp.log(jax.random.uniform(k_acc)) < log_alpha
        x = jnp.where(accept, x_new, x)
        lp = jnp.where(accept, lp_new, lp)
        return (x, lp), jnp.minimum(1.0, jnp.exp(log_alpha))

    # --- Warmup: dual-averaging step size + Welford diagonal mass. ---
    mu = jnp.log(10.0 * init_step_size)
    gamma, t0, kappa = 0.05, 10.0, 0.75

    def warmup_step(carry, inp):
        (x, lp), (log_eps, log_eps_bar, h_bar), (mean, m2), t = carry
        key_t = inp
        eps = jnp.exp(log_eps)
        (x, lp), alpha = hmc_step((x, lp), key_t, eps, inv_mass=jnp.ones(d),
                                  sqrt_mass=jnp.ones(d))
        # Dual averaging on the acceptance statistic.
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - alpha) / (t + t0)
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        # Welford running moments of the position (for the diagonal mass).
        delta = x - mean
        mean = mean + delta / t
        m2 = m2 + delta * (x - mean)
        return ((x, lp), (log_eps, log_eps_bar, h_bar), (mean, m2), t + 1.0), None

    k_warm, k_main = jax.random.split(key)
    lp0 = logp(flat0)
    init_carry = (
        (flat0, lp0),
        (
            jnp.log(jnp.asarray(init_step_size)),
            jnp.log(jnp.asarray(init_step_size)),
            jnp.asarray(0.0),
        ),
        (jnp.zeros(d, flat0.dtype), jnp.zeros(d, flat0.dtype)),
        jnp.asarray(1.0),
    )
    ((x, lp), (_, log_eps_bar, _), (mean, m2), t), _ = lax.scan(
        warmup_step, init_carry, jax.random.split(k_warm, n_warmup)
    )
    var = m2 / jnp.maximum(t - 2.0, 1.0)
    inv_mass = jnp.maximum(var, 1e-6)  # mass ≈ inverse posterior variance
    sqrt_mass = 1.0 / jnp.sqrt(inv_mass)
    # Rescale the adapted step size for the new metric (eps was tuned under
    # identity mass; the average per-dimension scale change is the safest
    # single-number correction).
    eps = jnp.exp(log_eps_bar)

    # Short re-adaptation under the final mass matrix.
    n_re = max(1, n_warmup // 4)

    def re_step(carry, key_t):
        (x, lp), (log_eps, log_eps_bar, h_bar), t = carry
        (x, lp), alpha = hmc_step((x, lp), key_t, jnp.exp(log_eps), inv_mass, sqrt_mass)
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - alpha) / (t + t0)
        log_eps = jnp.log(eps * 10.0) - jnp.sqrt(t) / gamma * h_bar
        w = t ** (-kappa)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        return ((x, lp), (log_eps, log_eps_bar, h_bar), t + 1.0), None

    ((x, lp), (_, log_eps_bar2, _), _), _ = lax.scan(
        re_step,
        ((x, lp), (jnp.log(eps), jnp.log(eps), jnp.asarray(0.0)), jnp.asarray(1.0)),
        jax.random.split(jax.random.fold_in(k_warm, 1), n_re),
    )
    eps = jnp.exp(log_eps_bar2)

    # --- Sampling with frozen (eps, mass). ---
    def sample_step(carry, key_t):
        carry, alpha = hmc_step(carry, key_t, eps, inv_mass, sqrt_mass)
        return carry, (carry[0], carry[1], alpha)

    _, (xs, lps, alphas) = lax.scan(
        sample_step, (x, lp), jax.random.split(k_main, n_samples)
    )
    samples = jax.vmap(unflatten)(xs)
    return HMCResult(samples, lps, jnp.mean(alphas), eps)
