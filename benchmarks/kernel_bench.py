"""Pallas (Triton) kernels against the plain XLA paths they replace, on a GPU.

For each kernel, at the bench shapes: compile it, compare each output with a
float64 host reference (and the XLA path with the same reference), and time
both.  A time is the median over rounds of ``reps`` back-to-back calls ended
by one ``block_until_ready``, divided by ``reps`` — the device-bound cost per
call once the host keeps the queue full.  Also times the multivariate
smoother's ``blocked`` and ``scan`` paths across state dimensions (the
``MvLGSSM.auto_method`` crossover).  Writes ``chiprun_out/kernel_bench.json``
and prints one JSON line per row.

    python benchmarks/kernel_bench.py [--only lgssm|hmm|hgf|mv]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _time(fn, *args, reps=20, rounds=5):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / reps)
    return {"us": statistics.median(per_call) * 1e6,
            "min_us": min(per_call) * 1e6, "first_call_s": first}


def _rel(got, want):
    """Largest absolute error over the reference's largest magnitude (≥ 1)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _emit(rows, row):
    rows.append(row)
    print(json.dumps(row), flush=True)


def lgssm_rows():
    import jax
    import jax.numpy as jnp

    from chip_smoke import _walks, ref_scalar_smoother
    from cortex_tpu.ops import (
        lgssm_smooth_matmul,
        lgssm_smooth_pallas,
        lgssm_smooth_scan,
        lgssm_smoother_operator,
    )

    rows = []
    for R, T in ((10_000, 100), (100_000, 100), (100_000, 1000)):
        y = jnp.asarray(_walks((R, T), seed=0))
        m_ref, _ = ref_scalar_smoother(y)
        op = lgssm_smoother_operator(T)
        variants = {
            "xla_scan": jax.jit(lgssm_smooth_scan),
            "xla_matmul": jax.jit(lambda y: lgssm_smooth_matmul(y, operator=op)),
        }
        variants["triton"] = lgssm_smooth_pallas
        for name, fn in variants.items():
            row = {"kernel": "lgssm_smooth", "shape": [R, T], "variant": name}
            row.update(_time(fn, y))
            row["mean_rel_err_vs_f64"] = _rel(fn(y).mean, m_ref)
            _emit(rows, row)
    return rows


def hmm_rows():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import ref_forward_backward
    from cortex_tpu.ops.hmm import hmm_forward_backward
    from cortex_tpu.ops.pallas_hmm import hmm_forward_backward_counts_pallas

    rows = []
    for R, T, K in ((4096, 64, 4), (4096, 64, 8), (4096, 64, 16)):
        rng = np.random.default_rng(1)
        lik = jnp.asarray(rng.random((R, T, K)) + 0.1, jnp.float32)
        A = rng.random((K, K)) + 0.2
        A = jnp.asarray(A / A.sum(1, keepdims=True), jnp.float32)
        pi = jnp.full((K,), 1.0 / K, jnp.float32)
        refs = ref_forward_backward(lik, A, np.asarray(pi))

        @jax.jit
        def scan(lik, A, pi):
            post = hmm_forward_backward(jnp.log(lik), jnp.log(A), jnp.log(pi))
            return (jnp.exp(post.log_gamma), jnp.exp(post.log_xi_sum),
                    post.log_evidence)

        variants = {"xla_scan": scan}
        variants["triton"] = (lambda lik, A, pi: tuple(
            hmm_forward_backward_counts_pallas(lik, A, pi)))
        for name, fn in variants.items():
            row = {"kernel": "hmm_counts", "shape": [R, T, K], "variant": name}
            row.update(_time(fn, lik, A, pi))
            for out, (label, ref) in zip(
                    fn(lik, A, pi),
                    zip(("gamma", "xi_sum", "log_evidence"), refs)):
                row[f"{label}_rel_err_vs_f64"] = _rel(out, ref)
            _emit(rows, row)
    return rows


def hgf_rows():
    import jax
    import jax.numpy as jnp

    from chip_smoke import _walks, ref_hgf
    from cortex_tpu.models import HGF
    from cortex_tpu.ops.pallas_hgf import ALL_TRACKS, hgf_filter_pallas

    rows = []
    hgf = HGF()
    R, T = 65536, 256
    u = jnp.asarray(_walks((R, T), seed=2, scale=0.1))
    fin_ref, _ = ref_hgf(u)
    for tracks in ((), ALL_TRACKS):
        variants = {"xla_scan": jax.jit(
            lambda u, tracks=tracks: hgf.filter(u, tracks=tracks))}
        variants["triton"] = (lambda u, tracks=tracks: hgf_filter_pallas(
            u, tracks=tracks))
        for name, fn in variants.items():
            row = {"kernel": "hgf_filter", "shape": [R, T],
                   "tracks": len(tracks), "variant": name}
            row.update(_time(fn, u))
            row["mu2_rel_err_vs_f64"] = _rel(fn(u)[0][2], fin_ref[2])
            _emit(rows, row)
    return rows


def mv_rows():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chip_smoke import _mv_model, _walks
    from cortex_tpu.models import MvLGSSM

    rows = []
    R, T = 1024, 100
    # d=16 is left out: compiling the blocked path there crashed the
    # process on an H100 (segmentation fault), see PERF.md.
    for d in (2, 4, 8, 12):
        model = MvLGSSM.from_arrays(*_mv_model(d, seed=d))
        y = jnp.asarray(np.swapaxes(_walks((R, d, T), seed=d, scale=0.3), 1, 2))
        for method in ("blocked", "scan"):
            fn = jax.jit(lambda y, method=method: model.smooth(y, method=method))
            row = {"kernel": "mv_lgssm_smooth", "shape": [R, T, d],
                   "variant": method, "auto": model.auto_method()}
            row.update(_time(fn, y, reps=5))
            _emit(rows, row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("lgssm", "hmm", "hgf", "mv"))
    args = ap.parse_args(argv)
    import jax

    from chip_smoke import card_line, configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_bench needs a GPU; default device is {dev.platform}")
    configure_compile_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    rows = []
    for name, fn in (("lgssm", lgssm_rows), ("hmm", hmm_rows),
                     ("hgf", hgf_rows), ("mv", mv_rows)):
        if args.only in (None, name):
            rows += fn()
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "kernel_bench.json"), "w") as f:
        json.dump({"card": card, "device_kind": dev.device_kind,
                   "jax": jax.__version__, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
