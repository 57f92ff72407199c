"""Linear Gaussian state-space model — the flagship benchmark family.

The compiled counterpart of the reference's chain SSM example
(``/root/reference/test/inference_engine_tests.jl:379-488``): BP smoothing
whose marginals are Kalman/RTS-equivalent.  Replicas (independent chains over
sharded datasets) batch along leading axes; a 10k-replica smoothing sweep is a
single fused XLA program.

Two interchangeable execution strategies (identical marginals):

- ``method="scan"``: sequential in time, batched over replicas — highest
  throughput when replicas ≫ chips,
- ``method="assoc"``: time-parallel associative scan, O(log T) depth — for
  long chains / interactive latency.

Free energy: for BP on a tree (the chain), −log Z is exact; we expose the
data log-evidence via the prediction-error decomposition for convergence /
monitoring (the reference has no free-energy computation; SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.chains import (
    ChainMarginals,
    lgssm_smooth_assoc,
    lgssm_smooth_matmul,
    lgssm_smooth_scan,
    scalar_kalman_update,
)

__all__ = ["LGSSM"]


@dataclasses.dataclass(frozen=True)
class LGSSM:
    """Scalar-state linear Gaussian SSM: ``x_t = A x_{t-1} + N(0,Q)``,
    ``y_t = H x_t + N(0,R)``.

    All parameters may be Python floats (static) — the typical case — and the
    model methods are jittable with ``y`` as the only traced input.
    """

    A: float = 1.0
    Q: float = 1.0
    H: float = 1.0
    R: float = 1.0

    def smooth(
        self,
        y: jax.Array,
        prior: Optional[Tuple[jax.Array, jax.Array]] = None,
        method: str = "scan",
    ) -> ChainMarginals:
        """Posterior marginals of all states given all observations.

        NaN entries in ``y`` are missing observations: they contribute no
        information (the smoother predicts through the gap).  A missing
        ``y[0]`` needs an explicit ``prior``.  (The Pallas fast path
        ``ops.lgssm_smooth_pallas`` requires dense data.)
        """
        if method == "scan":
            return lgssm_smooth_scan(y, self.A, self.Q, self.H, self.R, prior)
        if method == "assoc":
            return lgssm_smooth_assoc(y, self.A, self.Q, self.H, self.R, prior)
        if method == "matmul":
            # Matmul lowering: the smoother is affine in y (dense data only).
            return lgssm_smooth_matmul(y, self.A, self.Q, self.H, self.R, prior)
        raise ValueError(f"Unknown method: {method!r}")

    def filter(
        self,
        y: jax.Array,
        prior: Optional[Tuple[jax.Array, jax.Array]] = None,
    ) -> ChainMarginals:
        """Filtered beliefs p(x_t | y_{1:t}) via a forward scan (streaming
        posterior; the carry is the state you checkpoint and resume from).
        NaN observations carry zero information (pure prediction step)."""
        y = jnp.asarray(y)
        observed = ~jnp.isnan(y)
        y = jnp.where(observed, y, 0.0)
        yT = jnp.moveaxis(y, -1, 0)
        obsT = jnp.moveaxis(observed, -1, 0)
        A, Q, H, R = self.A, self.Q, self.H, self.R

        xi_obs = jnp.where(obsT, H * yT / R, 0.0)
        w_obs = jnp.where(obsT, jnp.asarray(H * H / R, y.dtype), 0.0)
        w_obs = jnp.broadcast_to(w_obs, yT.shape)

        if prior is not None:
            pm, pv = prior
            xi0 = xi_obs[0] + pm / pv
            w0 = w_obs[0] + 1.0 / pv
        else:
            xi0, w0 = xi_obs[0], w_obs[0]

        def step(carry, obs):
            xi_f, w_f = carry
            xi_o, w_o = obs
            # Division-safe rational projection (valid at w_f = 0, which a
            # missing-observation run produces):
            denom = A * A + Q * w_f
            new = (A * xi_f / denom + xi_o, w_f / denom + w_o)
            return new, new

        _, (xi_fs, w_fs) = jax.lax.scan(step, (xi0, w0), (xi_obs[1:], w_obs[1:]))
        xi_all = jnp.concatenate([xi0[None], xi_fs], axis=0)
        w_all = jnp.concatenate([w0[None], w_fs], axis=0)
        return ChainMarginals(
            jnp.moveaxis(xi_all / w_all, 0, -1), jnp.moveaxis(1.0 / w_all, 0, -1)
        )

    def log_evidence(
        self,
        y: jax.Array,
        prior: Tuple[jax.Array, jax.Array] = (0.0, 1.0),
    ) -> jax.Array:
        """log p(y_{1:T}) via the prediction-error decomposition, shape
        ``y.shape[:-1]`` (one value per replica).  NaN observations are
        marginalized out: they contribute zero log-likelihood and skip the
        measurement update."""
        y = jnp.asarray(y)
        observed = ~jnp.isnan(y)
        y = jnp.where(observed, y, 0.0)
        yT = jnp.moveaxis(y, -1, 0)
        obsT = jnp.moveaxis(observed, -1, 0)
        A, Q, H, R = self.A, self.Q, self.H, self.R
        pm = jnp.broadcast_to(jnp.asarray(prior[0], y.dtype), yT.shape[1:])
        pv = jnp.broadcast_to(jnp.asarray(prior[1], y.dtype), yT.shape[1:])

        def step(carry, inp):
            obs, mask = inp
            m, v = carry
            m_u, v_u, ll = scalar_kalman_update(obs, m, v, H, R)
            m_f = jnp.where(mask, m_u, m)
            v_f = jnp.where(mask, v_u, v)
            return (A * m_f, A * A * v_f + Q), jnp.where(mask, ll, 0.0)

        _, lls = jax.lax.scan(step, (pm, pv), (yT, obsT))
        return jnp.sum(lls, axis=0)

    def sample(
        self,
        key: jax.Array,
        T: int,
        batch_shape: Tuple[int, ...] = (),
        x0: float = 0.0,
    ) -> Tuple[jax.Array, jax.Array]:
        """Simulate ``(x, y)`` trajectories of length T, shape
        ``batch_shape + (T,)``."""
        kx, ky = jax.random.split(key)
        wn = jax.random.normal(kx, (T,) + batch_shape)
        vn = jax.random.normal(ky, (T,) + batch_shape)

        def step(x_prev, noise):
            x = self.A * x_prev + jnp.sqrt(self.Q) * noise
            return x, x

        x0_arr = jnp.broadcast_to(jnp.asarray(x0, wn.dtype), batch_shape)
        _, xs = jax.lax.scan(step, x0_arr, wn)
        ys = self.H * xs + jnp.sqrt(self.R) * vn
        return jnp.moveaxis(xs, 0, -1), jnp.moveaxis(ys, 0, -1)
