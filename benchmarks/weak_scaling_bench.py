"""Weak-scaling curves for every parallel path.

Fixed work PER DEVICE (replicas x chain steps per device constant), device
counts 1/2/4/8, for:

- replica-sharded LGSSM smoothing   (``parallel.mesh.shard_replicas``)
- time-sharded scalar smoother      (``parallel.lgssm_smooth_time_sharded``)
- time-sharded mv (d=4) smoother    (``parallel.mv_lgssm_smooth_time_sharded``)
- pipelined smoother                (``parallel.lgssm_smooth_pipelined``)

Runs on CPU with 8 VIRTUAL devices — this machine has ``ncores`` physical
cores (2 in the build image), so beyond ``ncores`` devices the virtual
devices time-share cores and ideal weak-scaling wall time grows by
``n/ncores``.  Two efficiencies are therefore reported:

- ``efficiency_raw``      = t_1 / t_n               (naive; meaningless past
                                                     ncores on this host)
- ``efficiency_adjusted`` = t_1 * max(1, n/ncores) / t_n
                                                    (capacity-adjusted: 1.0
                                                     = perfect weak scaling
                                                     given the cores that
                                                     actually exist)

``collective_fraction`` (1 - t_local/t_n, where t_local runs the same
per-device work on ONE device with no collectives) is reported only where
n <= ncores — oversubscription would otherwise pollute it.  These curves
validate the MECHANISM on virtual devices; hardware scaling numbers require
real multi-chip (BASELINE.md's 1->4-host axis).

Writes SCALING_r05.json.  Usage: python benchmarks/weak_scaling_bench.py
"""

import json
import os
import pathlib
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
REPO = pathlib.Path(__file__).resolve().parents[1]


def _time_median(fn, args_list):
    """Median wall seconds of fn over distinct pre-staged inputs."""
    import jax

    jax.block_until_ready(fn(*args_list[0]))  # compile + warm
    ts = []
    for args in args_list[1:]:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _variants(y, k=6):
    import jax

    ys = [y + 0.001 * i for i in range(k)]
    jax.block_until_ready(ys)
    return [(yi,) for yi in ys]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cortex_tpu.models import LGSSM, MvLGSSM
    from cortex_tpu.parallel import (
        lgssm_smooth_pipelined,
        lgssm_smooth_time_sharded,
        make_mesh,
        mv_lgssm_smooth_time_sharded,
        shard_replicas,
    )

    ncores = os.cpu_count() or 1
    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    model = LGSSM()
    rng = np.random.default_rng(0)
    paths = {}

    # -- replica-sharded: 2048 replicas per device, T=100 ------------------
    rows = []
    R_per, T = 2048, 100
    for n in counts:
        mesh = make_mesh([("replica", n)], devices=devices[:n])
        y = jnp.asarray(
            rng.normal(size=(R_per * n, T)).cumsum(axis=-1), jnp.float32
        )
        ys = shard_replicas(y, mesh)
        fn = jax.jit(lambda data: model.smooth(data, method="scan"))
        dt = _time_median(fn, _variants(ys))
        rows.append({"devices": n, "wall_s": round(dt, 4)})
    paths["replica_sharded_lgssm"] = {
        "work_per_device": f"{R_per} replicas x T={T}",
        "rows": rows,
        "collective_note": "embarrassingly parallel (no collectives); any "
        "adjusted-efficiency loss is runtime dispatch + oversubscription",
    }

    # -- time-sharded scalar: T=512 per device, 256 replicas ---------------
    rows = []
    Tb, Rb = 512, 256
    t_local = None
    for n in counts:
        mesh = make_mesh([("time", n)], devices=devices[:n])
        y = jnp.asarray(
            rng.normal(size=(Rb, Tb * n)).cumsum(axis=-1), jnp.float32
        )
        fn = jax.jit(
            lambda data, mesh=mesh: lgssm_smooth_time_sharded(
                data, mesh=mesh, prior=(0.0, 1.0)
            )
        )
        dt = _time_median(fn, _variants(y))
        row = {"devices": n, "wall_s": round(dt, 4)}
        if n == 1:
            t_local = dt
        elif n <= ncores:
            row["collective_fraction"] = round(max(0.0, 1 - t_local / dt), 3)
        rows.append(row)
    paths["time_sharded_scalar"] = {
        "work_per_device": f"T={Tb} x {Rb} replicas",
        "rows": rows,
    }

    # -- time-sharded mv (d=4): T=64 per device, 64 replicas ---------------
    rows = []
    d, Tmv, Rmv = 4, 64, 64
    mv = MvLGSSM.from_arrays(
        0.9 * np.eye(d), np.eye(d), np.eye(d), np.eye(d), np.zeros(d), np.eye(d)
    )
    margs = tuple(
        jnp.asarray(a) for a in (mv.A, mv.Q, mv.H, mv.R)
    )
    prior = (jnp.asarray(mv.m0), jnp.asarray(mv.P0))
    t_local = None
    for n in counts:
        mesh = make_mesh([("time", n)], devices=devices[:n])
        y = jnp.asarray(
            rng.normal(size=(Rmv, Tmv * n, d)).cumsum(axis=1), jnp.float32
        )
        fn = jax.jit(
            lambda data, mesh=mesh: mv_lgssm_smooth_time_sharded(
                data, *margs, prior, mesh=mesh
            )
        )
        dt = _time_median(fn, _variants(y))
        row = {"devices": n, "wall_s": round(dt, 4)}
        if n == 1:
            t_local = dt
        elif n <= ncores:
            row["collective_fraction"] = round(max(0.0, 1 - t_local / dt), 3)
        rows.append(row)
        # The per-device cost: wall time of the
        # whole sharded sweep IS the per-device cost (devices run in
        # lockstep; each holds Tmv steps x Rmv replicas).
    paths["time_sharded_mv_d4"] = {
        "work_per_device": f"T={Tmv} x {Rmv} replicas x d={d}",
        "rows": rows,
        "per_device_cost_note": "wall_s at n devices = per-device cost of "
        "one distributed sweep (lane-major sequential fold + fill-in per "
        "device + one all_gather of (d,d)-element totals each direction)",
    }

    # -- pipelined: T=256 per stage, 512-replica batch ---------------------
    # TWO microbatching policies per device count:
    # M = S (the r3 default whose bubble (S-1)/(2S-1) grows toward 1/2)
    # and M = 4S (bubble held < 0.2).  The bubble model's predicted
    # slowdown (S+M-1)/M rides along so the artifact itself shows which
    # regime the host is in: on THIS dispatch-bound 2-core host wall time
    # tracks the pipeline-STEP count (S+M-1) — per-step cost is nearly
    # independent of microbatch width at these tiny widths — so larger M
    # makes wall time WORSE even as the modeled bubble shrinks; the bubble
    # model governs only when per-step work dominates per-step dispatch
    # (real multi-chip with wide microbatches).  docs/scaling.md states
    # this law with the measured numbers.
    rows = []
    Tp, Rp = 256, 512
    t_local = None
    for n in counts:
        mesh = make_mesh([("time", n)], devices=devices[:n])
        y = jnp.asarray(
            rng.normal(size=(Rp, Tp * n)).cumsum(axis=-1), jnp.float32
        )
        for n_micro in sorted({n, 4 * n}):
            fn = jax.jit(
                lambda data, mesh=mesh, m=n_micro: lgssm_smooth_pipelined(
                    data, mesh=mesh, n_micro=m, prior=(0.0, 1.0)
                )
            )
            dt = _time_median(fn, _variants(y))
            bubble = (n - 1) / (n + n_micro - 1)
            row = {
                "devices": n,
                "n_micro": n_micro,
                "wall_s": round(dt, 4),
                "bubble_fraction_model": round(bubble, 3),
                "slowdown_model_vs_no_bubble": round(1.0 / (1.0 - bubble), 3),
                "pipeline_steps": n + n_micro - 1,
            }
            if n == 1 and n_micro == n:
                t_local = dt
            elif n <= ncores:
                row["collective_fraction"] = round(
                    max(0.0, 1 - t_local / dt), 3
                )
            rows.append(row)
    paths["pipelined"] = {
        "work_per_device": f"T={Tp} per stage x {Rp}-replica batch; "
        f"M in {{S, 4S}} microbatches",
        "rows": rows,
        "collective_note": "wall time on this host tracks pipeline_steps "
        "(per-step dispatch at tiny microbatch widths), NOT the bubble "
        "model — compare the M=S and M=4S rows at fixed S: the modeled "
        "bubble falls, the measured wall rises.  The bubble model "
        "(S+M-1)/M governs only when per-microbatch work dominates "
        "dispatch, i.e. real multi-chip with wide microbatches",
    }

    # Efficiencies.  The replica-sharded path has ZERO collectives, so its
    # weak-scaling curve measures the BACKEND's own multi-device behavior
    # (XLA:CPU runs a sharded computation's per-device partitions with
    # limited overlap: measured 1.8x wall for 2 devices x identical
    # per-device work on 2 free cores).  ``slowdown_vs_embarrassing``
    # divides that backend curve out: 1.0 = the path scales exactly like
    # the zero-collective path; the excess is the path's OWN
    # collective/bubble overhead — the number that transfers to real
    # multi-device hardware, where each device runs its partition
    # concurrently by construction.
    repl_curve = {
        r["devices"]: r["wall_s"] for r in paths["replica_sharded_lgssm"]["rows"]
    }
    repl_t1 = repl_curve[1]
    for path in paths.values():
        t1 = path["rows"][0]["wall_s"]
        for row in path["rows"]:
            n = row["devices"]
            row["efficiency_raw"] = round(t1 / row["wall_s"], 3)
            ideal = t1 * max(1.0, n / ncores)
            row["efficiency_adjusted"] = round(ideal / row["wall_s"], 3)
            backend_slow = repl_curve[n] / repl_t1
            row["slowdown_vs_embarrassing"] = round(
                (row["wall_s"] / t1) / backend_slow, 2
            )

    result = {
        "metric": "weak_scaling_fixed_work_per_device",
        "platform": "cpu_virtual_devices",
        "ncores_physical": ncores,
        "n_virtual_devices": len(devices),
        "labeling": "mechanism validation on virtual devices "
        "time-sharing {} physical cores; efficiency_adjusted divides out "
        "the structural n/ncores oversubscription; the remaining gap to "
        "1.0 is the XLA:CPU backend's limited inter-partition overlap "
        "(measured on the zero-collective replica-sharded path), so "
        "slowdown_vs_embarrassing is the per-path number that transfers "
        "to hardware — hardware scaling itself requires real multi-chip".format(
            ncores
        ),
        "paths": paths,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    out = REPO / "SCALING_r05.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    print(f"-> {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
