"""f32-vs-bf16 precision study: accuracy against an f64 oracle for the
flagship sweeps.

Accuracy (runs anywhere; oracle = float64 on CPU via `jax.enable_x64` in a
subprocess-free local scope):
- scalar LGSSM scan sweep, well-conditioned (unit parameters) and
  ill-conditioned (tiny observation noise -> precisions spanning ~1e6),
- MvLGSSM d=16, `assoc` (covariance-form associative scan) vs `sqrt`
  (QR square-root path) — the sqrt path is the documented answer for
  ill-conditioned chains in low precision.

Accuracy does not depend on the device, so every row runs on the CPU
backend.  The speed of the bf16 edge is measured by ``bench.py``
(``matmul_bf16`` rows).  Prints the table as JSON.
Usage: python benchmarks/precision_bench.py
"""

import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REPO = pathlib.Path(__file__).resolve().parents[1]
T = 100


def _f64_oracle_scalar(y, A, Q, H, R):
    """Dense information-form smoother in numpy float64."""
    yT = np.asarray(y, np.float64)
    n = yT.shape[-1]
    xi_obs = H * yT / R
    w_obs = np.full_like(yT, H * H / R)
    xi_f = np.zeros_like(yT)
    w_f = np.zeros_like(yT)
    for t in range(1, n):
        xi_c = xi_f[..., t - 1] + xi_obs[..., t - 1]
        w_c = w_f[..., t - 1] + w_obs[..., t - 1]
        denom = A * A + Q * w_c
        xi_f[..., t] = A * xi_c / denom
        w_f[..., t] = w_c / denom
    xi_b = np.zeros_like(yT)
    w_b = np.zeros_like(yT)
    for t in range(n - 2, -1, -1):
        xi_c = xi_b[..., t + 1] + xi_obs[..., t + 1]
        w_c = w_b[..., t + 1] + w_obs[..., t + 1]
        denom = 1.0 + Q * w_c
        xi_b[..., t] = A * xi_c / denom
        w_b[..., t] = A * A * w_c / denom
    w_m = w_obs + w_f + w_b
    xi_m = xi_obs + xi_f + xi_b
    return xi_m / w_m, 1.0 / w_m


def accuracy_tables():
    """Accuracy rows, forced onto the CPU backend: the f64 oracles need
    true float64 matmuls, and accuracy is device-independent anyway."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return _accuracy_tables_impl()


def _accuracy_tables_impl():
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import LGSSM, MvLGSSM

    rng = np.random.default_rng(0)
    out = {}

    # -- scalar LGSSM, well- and ill-conditioned ---------------------------
    for label, R_noise in (("well_conditioned_R1", 1.0), ("ill_conditioned_R1e-6", 1e-6)):
        y64 = rng.normal(size=(64, T)).cumsum(axis=1)
        mean64, var64 = _f64_oracle_scalar(y64, 1.0, 1.0, 1.0, R_noise)
        model = LGSSM(A=1.0, Q=1.0, H=1.0, R=R_noise)
        row = {}
        for dtype in ("float32", "bfloat16"):
            yj = jnp.asarray(y64, jnp.dtype(dtype))
            sm = model.smooth(yj, method="scan")
            m = np.asarray(sm.mean, np.float64)
            v = np.asarray(sm.variance, np.float64)
            row[dtype] = {
                "rmse_mean": float(np.sqrt(np.mean((m - mean64) ** 2))),
                "max_rel_err_var": float(
                    np.max(np.abs(v - var64) / np.maximum(var64, 1e-300))
                ),
            }
        out[f"lgssm_scan_{label}"] = row

    # -- MvLGSSM d=16: assoc (covariance) vs sqrt (QR) ---------------------
    d = 16
    A = 0.95 * np.eye(d)
    Q = np.eye(d) * 0.1
    H = np.eye(d)
    for label, r_scale in (("well_conditioned", 1.0), ("ill_conditioned_R1e-5", 1e-5)):
        m = MvLGSSM.from_arrays(
            A=A, Q=Q, H=H, R=np.eye(d) * r_scale, m0=np.zeros(d), P0=np.eye(d)
        )
        y = rng.normal(size=(8, T, d)).cumsum(axis=1)
        import jax

        # Oracle: the same sqrt path in f64 (x64 enabled locally).
        jax.config.update("jax_enable_x64", True)
        try:
            oracle = m.smooth(np.asarray(y, np.float64), method="sqrt")
            mean64 = np.asarray(oracle.mean, np.float64)
        finally:
            jax.config.update("jax_enable_x64", False)
        row = {}
        for method in ("assoc", "blocked", "sqrt"):
            sm = m.smooth(np.asarray(y, np.float32), method=method)
            mm = np.asarray(sm.mean, np.float64)
            finite = bool(np.isfinite(mm).all())
            row[f"{method}_f32"] = {
                "finite": finite,
                "rmse_mean": float(np.sqrt(np.mean((mm - mean64) ** 2)))
                if finite
                else None,
            }
        out[f"mv_lgssm_d16_{label}"] = row
    out["bf16_edge"] = bf16_edge_accuracy(rng)
    return out


def bf16_edge_accuracy(rng):
    """Accuracy of the precision policy's matmul configuration — bf16 inputs +
    bf16 affine operator with f32 accumulation — against the f64 oracle,
    next to the all-f32 matmul path.  Scalar chain + MvLGSSM d=4/d=16."""
    import jax.numpy as jnp

    from cortex_tpu.models import MvLGSSM
    from cortex_tpu.ops import lgssm_smooth_matmul, lgssm_smoother_operator
    from cortex_tpu.ops.chains_mv import (
        mv_lgssm_smooth_matmul,
        mv_lgssm_smoother_operator,
    )

    out = {}
    # Scalar chain.
    y64 = rng.normal(size=(64, T)).cumsum(axis=1)
    mean64, _ = _f64_oracle_scalar(y64, 1.0, 1.0, 1.0, 1.0)
    op = lgssm_smoother_operator(T)
    f32 = np.asarray(
        lgssm_smooth_matmul(jnp.asarray(y64, jnp.float32), operator=op).mean,
        np.float64,
    )
    S_bf = op[0].astype(jnp.bfloat16)
    bf = np.asarray(
        jnp.einsum(
            "rt,tj->rj",
            jnp.asarray(y64, jnp.bfloat16),
            S_bf,
            preferred_element_type=jnp.float32,
        )
        + op[1],
        np.float64,
    )
    scale = float(np.sqrt(np.mean(mean64**2)))
    out["lgssm_scalar_matmul"] = {
        "rmse_mean_f32": float(np.sqrt(np.mean((f32 - mean64) ** 2))),
        "rmse_mean_bf16_edge": float(np.sqrt(np.mean((bf - mean64) ** 2))),
        "signal_rms": scale,
    }
    # MvLGSSM.
    for d in (4, 16):
        m = MvLGSSM.from_arrays(
            A=0.9 * np.eye(d), Q=np.eye(d), H=np.eye(d), R=np.eye(d),
            m0=np.zeros(d), P0=np.eye(d),
        )
        y = rng.normal(size=(16, T, d)).cumsum(axis=1)
        import jax

        jax.config.update("jax_enable_x64", True)
        try:
            oracle = np.asarray(
                m.smooth(np.asarray(y, np.float64), method="scan").mean,
                np.float64,
            )
        finally:
            jax.config.update("jax_enable_x64", False)
        mvop = mv_lgssm_smoother_operator(
            T,
            jnp.asarray(m.A),
            jnp.asarray(m.Q),
            jnp.asarray(m.H),
            jnp.asarray(m.R),
            (jnp.asarray(m.m0), jnp.asarray(m.P0)),
        )
        f32m = np.asarray(
            mv_lgssm_smooth_matmul(
                jnp.asarray(y, jnp.float32), operator=mvop
            ).mean,
            np.float64,
        )
        flat = jnp.asarray(y, jnp.bfloat16).reshape(16, T * d)
        bfm = np.asarray(
            jnp.einsum(
                "rk,kj->rj",
                flat,
                mvop.L.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).reshape(16, T, d)
            + mvop.c,
            np.float64,
        )
        out[f"mv_lgssm_d{d}_matmul"] = {
            "rmse_mean_f32": float(np.sqrt(np.mean((f32m - oracle) ** 2))),
            "rmse_mean_bf16_edge": float(np.sqrt(np.mean((bfm - oracle) ** 2))),
            "signal_rms": float(np.sqrt(np.mean(oracle**2))),
        }
    return out


def main():
    result = {
        "platform": "cpu",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "accuracy": accuracy_tables(),
    }
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
