"""Vector-state LGSSM model wrapper (multivariate Kalman smoothing).

The d-dimensional counterpart of :class:`cortex_tpu.models.LGSSM`, backed by
the time-parallel matrix associative scan
(:func:`cortex_tpu.ops.chains_mv.mv_lgssm_smooth`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.chains_mv import (
    MvChainMarginals,
    mv_lgssm_filter,
    mv_lgssm_log_evidence,
    mv_lgssm_smooth,
)

__all__ = ["MvLGSSM"]


def _has_partial_missing(y) -> bool:
    """True iff concrete ``y`` has a step with SOME but not ALL components
    NaN — the case the fast shared-element builders cannot express.  Traced
    values return False (auto-detection cannot depend on data under jit)."""
    if isinstance(y, jax.core.Tracer):
        return False
    import numpy as np

    arr = np.asarray(y)
    nan = np.isnan(arr)
    if not nan.any():
        return False
    rows_any = nan.any(axis=-1)
    rows_all = nan.all(axis=-1)
    return bool((rows_any & ~rows_all).any())


@dataclasses.dataclass(frozen=True)
class MvLGSSM:
    """``x_t = A x_{t-1} + N(0, Q)``, ``y_t = H x_t + N(0, R)`` with
    ``A, Q: (d, d)``, ``H: (m, d)``, ``R: (m, m)``.

    Arrays are held as tuples-of-tuples for hashability (the model is a
    static argument of jitted functions); use :meth:`from_arrays`.
    """

    A: tuple
    Q: tuple
    H: tuple
    R: tuple
    m0: tuple
    P0: tuple

    @classmethod
    def from_arrays(cls, A, Q, H, R, m0, P0) -> "MvLGSSM":
        def t(a):
            a = jnp.asarray(a)
            if a.ndim > 1:
                return tuple(map(tuple, a.tolist()))
            return tuple(a.tolist())

        return cls(t(A), t(Q), t(H), t(R), t(m0), t(P0))

    @property
    def dim(self) -> int:
        return len(self.A)

    def auto_method(self) -> str:
        """The smoothing path :meth:`smooth` selects for ``method="auto"``.

        Shape-dependent: the blocked two-level scan's lane-major combine
        does d³ elementwise multiply-adds per replica, the sequential scan
        d² per step.  On an H100 at (R=1024, T=100) the blocked path ran
        5.4×, 4.5×, 2.2× and 1.4× faster than the scan at d=2, 4, 8 and 12,
        but its compile time grew from 11 s to 47 s (the scan's: 3-9 s) and
        at d=16 compiling it crashed the process; so "blocked" is chosen up
        to d=8 (PERF.md, Findings)."""
        return "blocked" if self.dim <= 8 else "scan"

    def smooth(
        self, y: jax.Array, method: str = "auto", missing: str = "auto"
    ) -> MvChainMarginals:
        """Posterior marginals; ``y``: ``(..., T, m)``.

        ``method="auto"`` (default): pick by state dimension — "blocked"
        for d ≤ 8, "scan" above (:meth:`auto_method`).
        ``method="blocked"``: two-level blocked scan — block-sequential
        folds + a B-element cross-block combine (the single-chip form of
        the time-sharded scheme; fastest at small d).
        ``method="scan"``: sequential filter + RTS scans (the choice above
        d = 8, where the lane-major combine's d³ work and compile time
        overtake the sequential recursion's batched d² steps).
        ``method="assoc"``: flat time-parallel associative scan —
        O(log T) depth but O(T log T) work; kept for reference, prefer
        "blocked".
        ``method="matmul"``: precomputed affine-operator matmul
        (dense data only).
        ``method="sqrt"``: sequential QR-factored square-root smoother
        (:func:`cortex_tpu.ops.sqrt_kalman.sqrt_lgssm_smooth`) — the
        numerically robust path for ill-conditioned chains in f32/bf16.

        ``missing`` controls NaN granularity:
        ``"component"`` masks individual observation components (a NaN in
        one component keeps the others' information — the granularity the
        reference's per-signal observations give for free,
        ``/root/reference/src/signal.jl:232-253``); ``"step"`` degrades
        the whole timestep on the blocked/assoc builders (their shared
        fast elements); ``"auto"`` (default) inspects concrete ``y`` and
        upgrades to "component" iff some step is partially observed —
        under ``jit`` (traced ``y``) it resolves to "step", so jitted
        callers with dense per-component gaps must pass
        ``missing="component"`` explicitly.  The "scan" path (and
        :meth:`filter`/:meth:`log_evidence`) always masks per component.
        """
        if method == "auto":
            method = self.auto_method()
        if missing not in ("auto", "step", "component"):
            raise ValueError(
                f"unknown missing={missing!r}; expected 'auto', 'step', "
                "or 'component'"
            )
        if missing == "auto":
            missing = "component" if _has_partial_missing(y) else "step"
        component = missing == "component"
        args = (
            y,
            jnp.asarray(self.A),
            jnp.asarray(self.Q),
            jnp.asarray(self.H),
            jnp.asarray(self.R),
            (jnp.asarray(self.m0), jnp.asarray(self.P0)),
        )
        if method == "assoc":
            return mv_lgssm_smooth(*args, component_missing=component)
        if method == "blocked":
            from ..ops.chains_mv import mv_lgssm_smooth_blocked

            return mv_lgssm_smooth_blocked(*args, component_missing=component)
        if method == "scan":
            from ..ops.chains_mv import mv_lgssm_smooth_seq

            return mv_lgssm_smooth_seq(*args)
        if method == "matmul":
            if component:
                raise ValueError(
                    "method='matmul' requires dense data (the precomputed "
                    "affine operator assumes every component observed); "
                    "use 'scan' or 'blocked' for per-component gaps"
                )
            from ..ops.chains_mv import mv_lgssm_smooth_matmul

            return mv_lgssm_smooth_matmul(*args)
        if method == "sqrt":
            if component:
                raise ValueError(
                    "method='sqrt' masks whole steps only; use 'scan' or "
                    "'blocked' for per-component gaps"
                )
            from ..ops.sqrt_kalman import sqrt_lgssm_smooth

            return sqrt_lgssm_smooth(*args)
        raise ValueError(
            f"unknown method {method!r}; expected 'auto', 'blocked', "
            "'assoc', 'scan', 'matmul', or 'sqrt'"
        )

    def _args(self, y):
        return (
            y,
            jnp.asarray(self.A),
            jnp.asarray(self.Q),
            jnp.asarray(self.H),
            jnp.asarray(self.R),
            (jnp.asarray(self.m0), jnp.asarray(self.P0)),
        )

    def filter(self, y: jax.Array) -> MvChainMarginals:
        """Filtered beliefs p(x_t | y_{1:t}); ``y``: ``(..., T, m)``.  NaNs
        are masked PER COMPONENT (a partially-observed step keeps the
        observed components' information); fully-NaN steps predict through
        the gap (streaming posterior)."""
        return mv_lgssm_filter(*self._args(y))

    def log_evidence(self, y: jax.Array) -> jax.Array:
        """log p(y_{1:T}) per replica via the prediction-error decomposition;
        differentiable in the parameters (close over arrays directly for ML
        system identification).  NaN components are marginalized
        analytically, per component."""
        return mv_lgssm_log_evidence(*self._args(y))

    def sample(
        self, key: jax.Array, T: int, batch_shape: Tuple[int, ...] = ()
    ) -> Tuple[jax.Array, jax.Array]:
        A = jnp.asarray(self.A)
        Q = jnp.asarray(self.Q)
        H = jnp.asarray(self.H)
        R = jnp.asarray(self.R)
        m0 = jnp.asarray(self.m0)
        P0 = jnp.asarray(self.P0)
        d, m = A.shape[0], H.shape[0]
        kx0, kx, ky = jax.random.split(key, 3)
        Lq = jnp.linalg.cholesky(Q)
        Lr = jnp.linalg.cholesky(R)
        L0 = jnp.linalg.cholesky(P0)
        x0 = m0 + jnp.einsum(
            "ij,...j->...i", L0, jax.random.normal(kx0, batch_shape + (d,))
        )
        wn = jax.random.normal(kx, (T,) + batch_shape + (d,))
        vn = jax.random.normal(ky, (T,) + batch_shape + (m,))

        def step(x_prev, noise):
            x = jnp.einsum("ij,...j->...i", A, x_prev) + jnp.einsum(
                "ij,...j->...i", Lq, noise
            )
            return x, x

        _, xs = jax.lax.scan(step, x0, wn)
        ys = jnp.einsum("ij,t...j->t...i", H, xs) + jnp.einsum(
            "ij,t...j->t...i", Lr, vn
        )
        return jnp.moveaxis(xs, 0, -2), jnp.moveaxis(ys, 0, -2)
