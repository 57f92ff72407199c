"""Hierarchical Gaussian Filter — streaming/online filtering.

BASELINE.md config: "Streaming hierarchical Gaussian filter — online filtering
over sharded replicas".  A 2-level continuous HGF (Mathys et al. 2011): the
hidden state's volatility is itself a Gaussian random walk,

    x2_t ~ N(x2_{t-1}, theta)
    x1_t ~ N(x1_{t-1}, exp(kappa*x2_t + omega))
    u_t  ~ N(x1_t, 1/pi_u)

with the standard closed-form precision-weighted prediction-error updates per
observation.  The filtering posterior is a tiny pytree state — exactly what
streams: :meth:`step` consumes one observation, :meth:`filter` scans a whole
series, and :func:`cortex_tpu.parallel.streaming.stream_filter` feeds chunks
from the host overlapped with device compute.  All updates are elementwise —
replicas batch along leading axes with one state per replica.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["HGF", "HGFState", "HGFTrajectory"]


class HGFState(NamedTuple):
    """Filtering posterior: means and precisions of both levels."""

    mu1: jax.Array
    pi1: jax.Array
    mu2: jax.Array
    pi2: jax.Array


class HGFTrajectory(NamedTuple):
    mu1: jax.Array
    pi1: jax.Array
    mu2: jax.Array
    pi2: jax.Array
    prediction_error: jax.Array  # level-1 volatility PE (delta1)


@dataclasses.dataclass(frozen=True)
class HGF:
    """2-level continuous HGF with fixed parameters.

    ``kappa``/``omega`` couple level 2 to level-1 volatility;``theta`` is the
    level-2 volatility; ``pi_u`` the observation (input) precision.
    """

    kappa: float = 1.0
    omega: float = -2.0
    theta: float = 0.05
    pi_u: float = 10.0
    # Numerical guards (the reference TAPAS implementation *errors out* on
    # negative posterior precisions; a streaming production filter must stay
    # finite instead): bound the log-volatility, floor the level-2 precision,
    # and cap the per-step level-2 jump.
    max_log_nu: float = 20.0
    min_pi2: float = 1e-2
    max_mu2_step: float = 5.0

    def init_state(self, batch_shape: Tuple[int, ...] = (), dtype=jnp.float32):
        z = jnp.zeros(batch_shape, dtype)
        return HGFState(z, jnp.ones_like(z), z, jnp.ones_like(z))

    def step(self, state: HGFState, u: jax.Array):
        """One streaming update: observation(s) ``u`` → new state + outputs.

        The closed-form variational update (precision-weighted prediction
        errors); all operations elementwise so replicas batch freely.
        """
        mu1, pi1, mu2, pi2 = state

        # Level-1 prediction through the volatility channel.
        muhat1 = mu1
        log_nu = jnp.clip(
            self.kappa * mu2 + self.omega, -self.max_log_nu, self.max_log_nu
        )
        nu = jnp.exp(log_nu)
        pihat1 = 1.0 / (1.0 / pi1 + nu)

        # Input update.
        pi1_new = pihat1 + self.pi_u
        mu1_new = muhat1 + (self.pi_u / pi1_new) * (u - muhat1)

        # Volatility prediction error.
        delta1 = (1.0 / pi1_new + (mu1_new - muhat1) ** 2) * pihat1 - 1.0

        # Level-2 update.
        pihat2 = 1.0 / (1.0 / pi2 + self.theta)
        w1 = nu * pihat1
        pi2_new = pihat2 + 0.5 * self.kappa**2 * w1 * (w1 + (2.0 * w1 - 1.0) * delta1)
        pi2_new = jnp.maximum(pi2_new, self.min_pi2)  # enforce positivity
        mu2_step = jnp.clip(
            0.5 * self.kappa * (w1 / pi2_new) * delta1,
            -self.max_mu2_step,
            self.max_mu2_step,
        )
        mu2_new = mu2 + mu2_step

        new_state = HGFState(mu1_new, pi1_new, mu2_new, pi2_new)
        return new_state, delta1

    def log_likelihood(self, u: jax.Array, state: HGFState = None) -> jax.Array:
        """One-step-ahead predictive log likelihood Σ_t log N(u_t; μ̂1_t,
        1/π̂1_t + 1/π_u), shape ``u.shape[:-1]`` — the fitting objective for
        HGF parameter estimation (differentiable w.r.t. the parameters when
        they are traced values)."""
        u = jnp.asarray(u)
        uT = jnp.moveaxis(u, -1, 0)
        if state is None:
            state = self.init_state(uT.shape[1:], u.dtype)

        def body(st, u_t):
            mu1, pi1, mu2, pi2 = st
            log_nu = jnp.clip(
                self.kappa * mu2 + self.omega, -self.max_log_nu, self.max_log_nu
            )
            pihat1 = 1.0 / (1.0 / pi1 + jnp.exp(log_nu))
            pred_var = 1.0 / pihat1 + 1.0 / self.pi_u
            ll = -0.5 * (
                jnp.log(2.0 * jnp.pi * pred_var) + (u_t - mu1) ** 2 / pred_var
            )
            new_st, _ = self.step(st, u_t)
            return new_st, ll

        _, lls = lax.scan(body, state, uT)
        return jnp.sum(lls, axis=0)

    def filter(
        self,
        u: jax.Array,
        state: HGFState = None,
        method: str = "scan",
        tracks: tuple = None,
        interpret: bool = False,
    ):
        """Filter a series ``u`` of shape ``(..., T)``; returns the final
        state and an :class:`HGFTrajectory` of the requested tracks
        (``None`` in the slots of unrequested ones).

        ``tracks``: subset of ``("mu1", "pi1", "mu2", "pi2", "delta1")``
        (default: all five).  Trajectory output traffic scales with the
        number of tracks — filtering-only callers should pass ``tracks=()``
        and read the final state.

        ``method="scan"``: one ``lax.scan`` (any batch shape, any initial
        state, traced parameters allowed).  ``method="pallas"``: the fused
        GPU kernel (``ops.pallas_hgf``) — the whole trajectory of a block
        of replicas in one program, with no intermediate device-memory
        traffic; requires ``u`` of shape ``(R, T)``, the default
        zero-initialized state, and CONCRETE (non-traced) model parameters
        — the kernel specializes on them; use ``method="scan"`` inside
        parameter-gradient workflows.  ``interpret`` runs that kernel in
        the Pallas interpreter (off a GPU it must be passed)."""
        from ..ops.pallas_hgf import ALL_TRACKS

        u = jnp.asarray(u)
        if tracks is None:
            tracks = ALL_TRACKS
        tracks = tuple(tracks)

        def to_traj(values):
            by_name = dict(zip(tracks, values))
            return HGFTrajectory(*(by_name.get(n) for n in ALL_TRACKS))

        if method == "pallas":
            if state is not None or u.ndim != 2:
                raise ValueError(
                    "method='pallas' requires u of shape (R, T) and the "
                    "default initial state"
                )
            from ..ops.pallas_hgf import hgf_filter_pallas

            finals, values = hgf_filter_pallas(
                u,
                kappa=self.kappa,
                omega=self.omega,
                theta=self.theta,
                pi_u=self.pi_u,
                max_log_nu=self.max_log_nu,
                min_pi2=self.min_pi2,
                max_mu2_step=self.max_mu2_step,
                tracks=tracks,
                interpret=interpret,
            )
            return HGFState(*finals), to_traj(values)
        if method != "scan":
            raise ValueError(
                f"unknown method {method!r}; expected 'scan' or 'pallas'"
            )
        uT = jnp.moveaxis(u, -1, 0)
        if state is None:
            state = self.init_state(uT.shape[1:], u.dtype)

        def body(st, u_t):
            new_st, delta1 = self.step(st, u_t)
            emitted = {
                "mu1": new_st.mu1,
                "pi1": new_st.pi1,
                "mu2": new_st.mu2,
                "pi2": new_st.pi2,
                "delta1": delta1,
            }
            return new_st, tuple(emitted[n] for n in tracks)

        final, traj = lax.scan(body, state, uT)
        return final, to_traj(tuple(jnp.moveaxis(a, 0, -1) for a in traj))
