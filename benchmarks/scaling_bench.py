"""Multi-device scaling harness: sweeps/s vs device count (BASELINE.md's
"≥90% linear scaling 1→4 hosts" methodology).

Shards the 10k-replica LGSSM smoothing sweep over a ``replica`` mesh of
1, 2, 4, ... devices and reports sweeps/s + parallel efficiency.  On
several GPU hosts, run after ``cortex_tpu.parallel.init_distributed()``; on a
single CPU host, set::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8

to exercise the harness on virtual devices (virtual devices share the same
physical cores, so those numbers validate the mechanism, not the hardware
scaling).

Usage: python benchmarks/scaling_bench.py [replicas] [T]
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import LGSSM
    from cortex_tpu.parallel import make_mesh, shard_replicas

    replicas = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 100

    ndev_total = len(jax.devices())
    model = LGSSM()
    rng = np.random.default_rng(0)
    y_host = rng.normal(size=(replicas, T)).cumsum(axis=-1).astype(np.float32)

    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev_total]
    results = []
    base = None
    for n in counts:
        pad = (-replicas) % n
        y = np.concatenate([y_host, y_host[: pad]]) if pad else y_host
        mesh = make_mesh([("replica", n)], devices=jax.devices()[:n])
        y_sharded = shard_replicas(jnp.asarray(y), mesh)
        smooth = jax.jit(lambda data: model.smooth(data, method="scan"))
        jax.block_until_ready(smooth(y_sharded))
        ys = [y_sharded + float(i) for i in range(8)]
        jax.block_until_ready(ys)
        ts = []
        for yi in ys:
            t0 = time.perf_counter()
            jax.block_until_ready(smooth(yi))
            ts.append(time.perf_counter() - t0)
        dt = float(np.median(ts))
        sweeps_per_s = 1.0 / dt
        if base is None:
            base = sweeps_per_s
        eff = sweeps_per_s / (base * n)
        results.append(
            {
                "devices": n,
                "sweeps_per_s": round(sweeps_per_s, 2),
                "efficiency_vs_linear": round(eff, 3),
            }
        )
        print(json.dumps(results[-1]))

    print(
        json.dumps(
            {
                "metric": "lgssm_replica_sharded_scaling",
                "replicas": replicas,
                "T": T,
                "platform": jax.devices()[0].platform,
                "results": results,
            }
        )
    )


if __name__ == "__main__":
    main()
