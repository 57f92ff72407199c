"""Benchmark: message-update throughput on a 10k-replica LGSSM smoothing sweep.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Primary metric (BASELINE.md): message updates/sec/chip on a 10k-replica,
T=100 LGSSM Belief-Propagation smoothing sweep.  One sweep computes, per
replica, (T-1) forward messages + (T-1) backward messages + T marginals =
3T-2 signal updates — the same accounting as the reference's dynamic engine
executions for one `update_marginals!` pass over the chain.

Methodology: every path is jitted, warmed up, then timed as ``repeats``
rounds of ``K`` back-to-back calls, each round ended by one
``block_until_ready`` — the per-call device-bound time once the host keeps
the queue full.  Inputs come from a fixed seed.  Times are medians over the
rounds, with min and max alongside (``_sweep_stats``).  A section that
fails stops the run with its traceback.

Artifacts: the full detail is WRITTEN to ``BENCH_DETAIL.json``; the
bench-generated regions of the docs are re-rendered from it.  stdout carries
one compact final JSON line.

Roofline: a matched-traffic probe (read the (R,T) input once, write two
(R,T) outputs, as the paths do) timed identically is the denominator;
``pct_matched_probe`` = probe/path.  The traffic model counts the input
read and the mean/variance writes.  Peaks come from ``KNOWN_PEAKS``, keyed
by ``device_kind``; an unknown device is an error.

Paths measured:
- ``matmul``      — matmul lowering: the smoother is affine in y
  (ops/chains.py ``lgssm_smooth_matmul``), one (R,T)x(T,T) matmul at
  Precision.HIGHEST.
- ``matmul_bf16`` — the precision policy's bf16-edge config (bf16 inputs +
  operator, f32 accumulation).
- ``scan``        — two batched ``lax.scan`` passes (ops/chains.py).
- ``pallas``      — the fused Triton kernel (ops/pallas_kernels.py).
- ``generic_*``   — the factor-graph paths through ``CompiledInference``:
  the lowered BP chain (``generic_path``), mean-field VMP vs a
  hand-written Jacobi sweep (``generic_vmp``), and structured VMP with
  warm/steady decomposition (``generic_structured``).
- ``ladder``      — HMM+Dirichlet VMP (scan and the Triton E-step),
  GMM at a resource-bound shape (R=8192), MvLGSSM
  (scan/blocked/assoc/matmul/matmul_bf16 with MFU + auto-default check),
  streaming HGF (full-trajectory + trimmed-track + bf16 kernel configs,
  each against a measured compute floor).

``vs_baseline``: the reference publishes no numbers (BASELINE.md), so the
baseline is the reference *architecture* — a dynamic per-signal reactive
engine (our reference-faithful Python implementation, measured on the same
machine, same model family) — giving the speedup of the compiled dataflow
path over per-edge dynamic message passing.
"""

import json
import sys
import time

import numpy as np

T = 100


def _section(name, fn, *args, **kwargs):
    """Run one bench section, logging its wall time to stderr.  A failure
    propagates: a bench with a missing section is not a result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[bench] {name}: {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)
    return out


def _sweep_stats(fn, y0, K, aux=(), repeats=3):
    """Per-call device-bound time of ``fn(y0, *aux)``.

    The jitted call is compiled and warmed up, then timed as ``repeats``
    rounds of ``K`` back-to-back calls, each round ended by one
    ``block_until_ready``.  Returns ``(median_seconds, stats_dict)``.
    Large operands ride in ``aux`` as jit arguments rather than closed-over
    constants, so they are not baked into the compiled program."""
    import jax

    g = jax.jit(fn)
    aux = tuple(aux)
    jax.block_until_ready(g(y0, *aux))  # compile + warm
    per_call = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(K):
            out = g(y0, *aux)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / K)
    per_call.sort()
    med = per_call[len(per_call) // 2]
    stats = {
        "median_us": round(med * 1e6, 1),
        "min_us": round(per_call[0] * 1e6, 1),
        "max_us": round(per_call[-1] * 1e6, 1),
        "repeats": repeats,
        "calls_per_repeat": K,
    }
    return med, stats


def _sweep_time(fn, y0, K, aux=(), repeats=1):
    """Median device-bound seconds per call (see :func:`_sweep_stats`)."""
    med, _ = _sweep_stats(fn, y0, K, aux=aux, repeats=repeats)
    return med


def _make_data(R):
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    y0 = jnp.cumsum(jax.random.normal(key, (R, T), jnp.float32), -1)
    return jax.block_until_ready(y0)


def bench_paths(R, K):
    """Per-path sweep-time stats at R replicas (+ matched-traffic probe).

    ``matmul_bf16`` is the precision-policy configuration (docs/precision.md:
    bf16 on the matmul edge, f32 accumulation): y and the (T, T) operator
    cast to bf16, accumulated f32 via ``preferred_element_type``."""
    import jax.numpy as jnp

    from cortex_tpu.models import LGSSM
    from cortex_tpu.ops import lgssm_smooth_matmul, lgssm_smoother_operator
    from cortex_tpu.ops.pallas_kernels import lgssm_smooth_pallas

    model = LGSSM(A=1.0, Q=1.0, H=1.0, R=1.0)
    op = lgssm_smoother_operator(T)
    S_bf16 = op[0].astype(jnp.bfloat16)
    c_f32, v_f32 = op[1], op[2]

    def matmul_bf16(y, S, c, v):
        mean = (
            jnp.einsum(
                "rt,tj->rj",
                y.astype(jnp.bfloat16),
                S,
                preferred_element_type=jnp.float32,
            )
            + c
        )
        return mean, jnp.broadcast_to(v, y.shape)

    y0 = _make_data(R)
    # The (T,T) operator rides as a jit argument (see _sweep_stats).
    paths = {
        "matmul": (lambda y, o: lgssm_smooth_matmul(y, operator=o), (op,)),
        "matmul_bf16": (matmul_bf16, (S_bf16, c_f32, v_f32)),
        "scan": (lambda y: model.smooth(y, method="scan"), ()),
        "pallas": (lambda y: lgssm_smooth_pallas(y), ()),
        "probe": (lambda y: (y * 1.000001, y + 0.5), ()),
    }
    return {
        name: _sweep_stats(fn, y0, K, aux=aux)[1]
        for name, (fn, aux) in paths.items()
    }


def bench_generic_compiled(R, K):
    """The factor-graph path: CompiledInference over the T=100 chain graph
    (chain lowering rerolls the schedule into one lax.scan), replica-batched.

    Uses the executor's packed I/O end to end: one ``source_pack`` feeds all
    T observation sources (rows permuted into ``schedule.sources`` order by
    key — NOT construction order), and ``packed=True`` marginals are consumed
    as one family via ``smart_stack`` (a single concat+gather across the
    interior/endpoint rule-group packs)."""
    import jax.numpy as jnp

    from cortex_tpu.compile import CompiledInference, smart_stack
    from cortex_tpu.models import LGSSMChainBatched, make_chain_graph

    engine, x, y, likelihood = make_chain_graph(T)
    compiled = CompiledInference(engine, x, LGSSMChainBatched())
    vid_to_obs = {yv: i for i, yv in enumerate(y)}
    perm_list = [vid_to_obs[k[1]] for k in compiled.source_keys()]
    # Sources are variant-sorted (schedule._variant_order_key), so for the
    # chain the permutation is the identity and the pack feeds straight in.
    identity = perm_list == list(range(T))
    perm = jnp.asarray(perm_list)
    y0 = _make_data(R)

    def fn(data):
        # data: (R, T) -> source pack (T, R), row i = sources[i]'s value.
        pack = data.T if identity else data.T[perm]
        marginals, _ = compiled.run({}, source_pack=pack, packed=True)
        fam = smart_stack([marginals[xi] for xi in x])  # (T, R) Gaussian
        return fam.mean, fam.variance

    lowered = bool(compiled.plan is not None and compiled.plan.scan_segments)
    dt = _sweep_time(fn, y0, K, repeats=3)
    # Scan reference in the same section, for the executor-overhead ratio.
    from cortex_tpu.models import LGSSM

    model = LGSSM(A=1.0, Q=1.0, H=1.0, R=1.0)

    def scan_fn(d):
        m = model.smooth(d, method="scan")
        return m.mean, m.variance

    dt_scan = _sweep_time(scan_fn, y0, K, repeats=3)
    return dt, lowered, dt_scan


def bench_generic_vmp(R, K, n=100, iters=4):
    """The compiled MEAN-FIELD VMP path vs a hand-written jnp Jacobi sweep
    of the same updates.

    Model: the reference's mean-field gold SSM (unknown process/observation
    precisions, ``test/inference_engine_tests.jl:593-805``) as a factor
    graph (``models/vmp_graph.py``), replica-batched to R by feeding (R,)
    values through the frozen y-marginal initials.  The hand-written sweep
    reproduces the compiled dataflow semantics exactly (all messages from
    the previous sweep's marginals, then all marginals — synchronous
    Jacobi), so the two fixed points agree to float tolerance; the ratio of
    their per-iteration device times is pure compiled-path overhead."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cortex_tpu.compile import CompiledInference, dep_role_key
    from cortex_tpu.models import MeanFieldSSMBatched, make_mean_field_ssm_graph

    engine, x, y, ssnoise, obsnoise = make_mean_field_ssm_graph(n, [0.0] * n)
    compiled = CompiledInference(
        engine,
        [ssnoise, obsnoise] + x,
        MeanFieldSSMBatched(),
        refine_key=dep_role_key,
    )
    base_state = compiled.initial_state()
    y_pos = {id(engine.get_variable_marginal(v)): i for i, v in enumerate(y)}

    def compiled_fn(data):  # data: (R, n)
        state = []
        for s, v in zip(compiled.schedule.initials, base_state):
            if id(s) in y_pos:
                state.append(data[:, y_pos[id(s)]])
            else:
                state.append(
                    jax.tree_util.tree_map(
                        lambda a: jnp.broadcast_to(
                            jnp.asarray(a), (R,) + jnp.shape(a)
                        ),
                        v,
                    )
                )
        marg, _ = compiled.iterate({}, iters, state)
        return marg[ssnoise].mean, marg[obsnoise].mean, marg[x[0]].mean

    def handwritten_fn(data):
        def sweep(carry, _):
            qm, qv, qss_mean, qobs_mean = carry
            lik_prec = qobs_mean[:, None]
            trans = qss_mean[:, None]
            has_l = jnp.pad(jnp.ones_like(qm[:, 1:]), ((0, 0), (1, 0)))
            has_r = jnp.pad(jnp.ones_like(qm[:, :-1]), ((0, 0), (0, 1)))
            prec = lik_prec + trans * (has_l + has_r)
            wmean = (
                lik_prec * data
                + trans * jnp.pad(qm[:, :-1], ((0, 0), (1, 0)))
                + trans * jnp.pad(qm[:, 1:], ((0, 0), (0, 1)))
            )
            qm_new = wmean / prec
            qv_new = 1.0 / prec
            rate_obs = 0.5 * (qv + (data - qm) ** 2)
            qobs_new = (1.5 * n - (n - 1.0)) / jnp.sum(rate_obs, axis=1)
            rate_ss = 0.5 * (
                qv[:, :-1] + qv[:, 1:] + (qm[:, :-1] - qm[:, 1:]) ** 2
            )
            qss_new = (1.5 * (n - 1.0) - (n - 2.0)) / jnp.sum(rate_ss, axis=1)
            return (qm_new, qv_new, qss_new, qobs_new), None

        init = (
            jnp.zeros_like(data),
            jnp.ones_like(data),
            jnp.ones(data.shape[0], data.dtype),
            jnp.ones(data.shape[0], data.dtype),
        )
        (qm, qv, qss, qobs), _ = lax.scan(sweep, init, None, length=iters)
        return qss, qobs, qm[:, 0]

    y0 = _make_data(R)[:, :n] * 0.1
    # Fixed-point agreement (same data): proves the handwritten
    # loop IS the same algorithm before its time is used as a denominator.
    a = jax.jit(compiled_fn)(y0)
    b = jax.jit(handwritten_fn)(y0)
    agree = max(
        float(jnp.max(jnp.abs(ai - bi) / (jnp.abs(bi) + 1e-6)))
        for ai, bi in zip(a, b)
    )
    dt_c, stats_c = _sweep_stats(compiled_fn, y0, K)
    dt_h, stats_h = _sweep_stats(handwritten_fn, y0, K)
    return {
        "replicas": R, "n": n, "iters_per_call": iters,
        "per_iter_us_compiled": round(dt_c / iters * 1e6, 1),
        "per_iter_us_handwritten": round(dt_h / iters * 1e6, 1),
        "call_stats_us": {"compiled": stats_c, "handwritten": stats_h},
        "ratio_vs_handwritten": round(dt_c / dt_h, 2),
        "agreement_max_rel": round(agree, 6),
        "gap_decomposition": "the compiled steady sweep materializes "
        "every per-edge message (8 batched rule groups, ~500 (R,)-rows "
        "of messages + marginal packs per iteration) where the "
        "hand-written sweep fuses messages into the marginal updates "
        "and only touches data + q arrays — the ratio tracks the "
        "device-memory traffic multiple of the generic dataflow "
        "representation",
    }


def bench_generic_structured(R, K, n=100, iters=4):
    """On-chip per-iteration cost of the compiled STRUCTURED VMP path —
    the third model family through the generic compiler (pairwise 2×2
    joint marginals over transition clusters,
    ``models/structured_graph.py``; reference gold model
    ``test/inference_engine_tests.jl:807-1147``).

    One ``iterate(steady_state=True)`` call = 1 dataflow-ordered
    WARM-START sweep + (iters-1) Jacobi steady-state sweeps (ONE phase of
    13 batched groups).  The warm start does NOT run the raw 207-phase
    schedule: the chain-mining lowering rerolls it into a 14-segment plan
    (one length-98 ``lax.scan`` over the transition-message recurrences +
    the O(log n) segment-tree product levels).  Long VMP runs amortize it;
    both numbers are reported, decomposed from two call lengths via
    t(i) = warm + (i-1)·steady."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.compile import CompiledInference, dep_role_key
    from cortex_tpu.models import (
        StructuredSSMBatched,
        make_structured_ssm_graph,
    )

    engine, x, y, ssnoise, obsnoise = make_structured_ssm_graph(n, [0.0] * n)
    compiled = CompiledInference(
        engine,
        [ssnoise, obsnoise] + x,
        StructuredSSMBatched(),
        refine_key=dep_role_key,
    )
    base_state = compiled.initial_state()
    y_pos = {id(engine.get_variable_marginal(v)): i for i, v in enumerate(y)}

    def fn(data, n_it):
        state = []
        for s, v in zip(compiled.schedule.initials, base_state):
            if id(s) in y_pos:
                state.append(data[:, y_pos[id(s)]])
            else:
                state.append(
                    jax.tree_util.tree_map(
                        lambda a: jnp.broadcast_to(
                            jnp.asarray(a), (R,) + jnp.shape(a)
                        ),
                        v,
                    )
                )
        marg, _ = compiled.iterate({}, n_it, state, steady_state=True)
        return marg[ssnoise].mean, marg[obsnoise].mean, marg[x[0]].mean

    y0 = _make_data(R)[:, :n] * 0.1
    iters2 = iters + 8
    fn_long = lambda data: fn(data, iters2)
    fn_short = lambda data: fn(data, iters)
    dt_s, stats_s = _sweep_stats(fn_short, y0, K)
    dt_l, stats_l = _sweep_stats(fn_long, y0, max(4, K // 2))
    steady = max(1e-9, (dt_l - dt_s) / (iters2 - iters))
    warm = max(0.0, dt_s - (iters - 1) * steady)
    return {
        "replicas": R, "n": n,
        "warm_start_sweep_us": round(warm * 1e6, 1),
        "steady_iter_us": round(steady * 1e6, 1),
        "call_stats_us": {
            f"iters{iters}": stats_s,
            f"iters{iters2}": stats_l,
        },
        # Each steady iteration computes (n-1) joint 2x2 marginals + n
        # individual marginals + 2 precision posteriors per replica.
        "joint_updates_per_s": round(R * (n - 1) / steady, 1),
        "note": "warm start = the dataflow-ordered first sweep (207 "
        "serialized phases); steady = the one-phase Jacobi sweep that "
        "all subsequent iterations run",
    }


def bench_dynamic_engine(T=100, sweeps=3):
    """Reference-architecture baseline: dynamic reactive engine on one chain."""
    from cortex_tpu.models import LGSSMChainDynamic, make_chain_graph

    times = []
    for _ in range(sweeps):
        engine, x, y, likelihood = make_chain_graph(
            T, processor=LGSSMChainDynamic()
        )
        rng = np.random.default_rng(1)
        data = rng.normal(size=T).cumsum()
        for i in range(T):
            engine.get_message_to_factor(y[i], likelihood[i]).set_value(
                float(data[i])
            )
        t0 = time.perf_counter()
        engine.update_marginals(x)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    updates_per_sweep = 3 * T - 2
    return updates_per_sweep / dt


# Published peaks, keyed by ``device_kind``: the denominators for the
# %-of-peak and MFU figures.  Source: NVIDIA H100 data sheet, SXM part,
# dense rates without sparsity, at the 700 W power limit (a card set lower
# cannot hold its top clock under a matmul-heavy load).
KNOWN_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_GBps": 3350.0,
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
    },
}


def bench_hw_peaks():
    """Anchor the roofline to hardware: the card's published peaks plus
    measured saturating probes (1 GB streaming copy; 8192^3 bf16 matmul).
    A device missing from :data:`KNOWN_PEAKS` is an error."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import card_line

    dev = jax.devices()[0]
    kind = dev.device_kind
    if kind not in KNOWN_PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {kind!r}; add a row with "
            "its source to bench.KNOWN_PEAKS"
        )
    spec = KNOWN_PEAKS[kind]

    # Device memory: 1 GB f32 stream, read+write = 2 GB traffic per call.
    n = 1 << 28
    x = jax.block_until_ready(
        jnp.broadcast_to(jnp.arange(1 << 14, dtype=jnp.float32), (1 << 14, 1 << 14))
        .reshape(-1)[:n]
        .copy()
    )
    dt = _sweep_time(lambda v: v * 1.000001, x, 20)
    hbm_probe_GBps = 2 * n * 4 / dt / 1e9
    del x

    # Tensor cores: (8192, 8192) bf16 matmul — 2*8192^3 = 1.1e12 FLOP per call.
    m = 8192
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (m, m), jnp.bfloat16)
    a = jax.block_until_ready(jax.random.normal(key, (m, m), jnp.float32))
    dt = _sweep_time(
        lambda v, ww: v.astype(jnp.bfloat16) @ ww, a, 20, aux=(w,)
    )
    matmul_probe_tflops = 2 * m**3 / dt / 1e12
    del a, w
    return {
        "device_kind": kind,
        "card": card_line(),
        "spec_hbm_GBps": spec["hbm_GBps"],
        "spec_bf16_tflops": spec["bf16_tflops"],
        "measured_hbm_probe_GBps": round(hbm_probe_GBps, 1),
        "measured_matmul_probe_bf16_tflops": round(matmul_probe_tflops, 1),
    }


def _flops_of(fn, *args):
    """XLA's own FLOP count for one call (exact MFU numerator)."""
    import jax

    c = jax.jit(fn).lower(*args).compile().cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else (c or {})
    return float(c.get("flops", 0.0))


def _scale_iter_stats(stats, iters):
    """Divide the per-sweep time keys of a stats dict by ``iters``."""
    keep = {"repeats", "calls_per_repeat"}
    return {k: (v if k in keep else round(v / iters, 1)) for k, v in stats.items()}


def _ladder_hmm(K):
    """HMM forward-backward + Dirichlet VMP (pooled, R replicas): the
    log-space scan E-step and the Triton kernel E-step."""
    import jax.numpy as jnp

    from cortex_tpu.models import HMM

    R_, T_, Kh, M = 4096, 64, 4, 8
    hmm = HMM(K=Kh, log_pi=jnp.log(jnp.full(Kh, 1.0 / Kh)))
    base = _make_data(R_)[:, :T_]  # float walks; symbols derived inside
    iters = 4

    def make_fn(method):
        def fn(data):
            obs = jnp.clip(jnp.abs(data).astype(jnp.int32) % M, 0, M - 1)
            res = hmm.fit_vmp(
                obs, M, n_iterations=iters, pooled=True, method=method
            )
            return res.state.trans_alpha, res.state.emis_alpha, res.elbo

        return fn

    dts, stats = {}, {}
    for method in ("scan", "pallas"):
        dts[method], st = _sweep_stats(make_fn(method), base, K)
        stats[method] = _scale_iter_stats(st, iters)
    out = {
        "replicas": R_, "T": T_, "K": Kh, "M": M,
        "per_vmp_iter_us": stats,
        "ratio_scan_over_pallas": round(dts["scan"] / dts["pallas"], 2),
    }
    best = min(dts.values()) / iters
    # One VMP iteration touches R*T state marginals + R*(T-1) pairwise
    # counts + R*T emission contributions ~= 3 updates per step.
    out["msg_updates_per_s"] = round(R_ * T_ * 3 / best, 1)
    return out


def _ladder_gmm(K, hbm_peak, matmul_peak):
    """GMM structured VMP (R independent replicas) — anchored: XLA FLOP
    count, achieved TFLOP/s vs bf16 spec peak, a matched-traffic probe, and
    the binding resource named from the two ratios.

    R=8192: at the old R=256 nothing was measurable —
    the per-iteration time was launch latency on tiny operands.  At
    (8192, 256, 2, 4) one iteration's E-step alone moves ~50 MB
    (x + responsibilities), so FLOPs/traffic must explain the time."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import GMM

    Rg, N, D, Kg = 8192, 256, 2, 4
    key = jax.random.PRNGKey(1)
    xg = jax.block_until_ready(
        jax.random.normal(key, (Rg, N, D), jnp.float32)
        + 3.0 * jax.random.randint(key, (Rg, N, 1), 0, Kg).astype(jnp.float32)
    )
    gmm = GMM(K=Kg)
    giters = 4

    def gmm_fn(data):
        res = gmm.fit(data, n_iterations=giters)
        return res.posterior.m, res.posterior.alpha, res.free_energy

    dt, stats = _sweep_stats(gmm_fn, xg, K)
    dt /= giters
    stats = _scale_iter_stats(stats, giters)
    flops = _flops_of(gmm_fn, xg) / giters
    # Matched-traffic probe: per iteration the E-step reads x (R,N,D) and
    # writes responsibilities (R,N,K); the M-step reductions touch (R,K,·)
    # (negligible).  Probe = read x once, write a (R,N,K) output.
    def probe_fn(data):
        return data * 1.000001, jnp.broadcast_to(
            data.sum(-1, keepdims=True), (Rg, N, Kg)
        )

    dt_probe = _sweep_time(probe_fn, xg, max(8, K))
    # Minimal traffic = the x read per iteration (probe outputs fuse into
    # the harness reduction, path intermediates between E/M fusions do
    # not necessarily).  The probe ratio measures the path's REAL traffic
    # multiple over that floor.
    bytes_iter = Rg * N * D * 4
    achieved_tflops = flops / dt / 1e12
    pct_matmul = 100 * achieved_tflops / matmul_peak
    pct_hbm = 100 * bytes_iter / dt / 1e9 / hbm_peak
    probe_ratio = dt / max(dt_probe, 1e-9)
    if pct_matmul > max(pct_hbm, 5.0):
        binding = "compute"
    elif probe_ratio >= 2.0:
        binding = (
            f"HBM traffic on materialized intermediates: the iteration "
            f"runs {probe_ratio:.1f}x its matched minimal-traffic probe "
            f"(XLA fusion boundaries between the E/M steps re-read and "
            f"re-write (R,N,K)-shaped arrays the minimal model elides)"
        )
    else:
        binding = "HBM bandwidth (matched to the minimal-traffic probe)"
    return {
        "replicas": Rg, "N": N, "D": D, "K": Kg,
        "per_vmp_iter_us": stats,
        "resp_updates_per_s": round(Rg * N * Kg / dt, 1),
        "xla_flops_per_iter": flops,
        "achieved_tflops": round(achieved_tflops, 3),
        "pct_of_bf16_peak": round(pct_matmul, 2),
        "bytes_per_iter": bytes_iter,
        "pct_hbm_spec_peak": round(pct_hbm, 1),
        "matched_probe_us": round(dt_probe * 1e6, 1),
        "pct_matched_probe": round(100 * dt_probe / dt, 1),
        "binding_resource": binding,
    }


def _ladder_mv(K, matmul_peak):
    """MvLGSSM smoothing: all five lowerings + the bf16-edge matmul.

    ``matmul_bf16`` is the precision policy's configuration (bf16 inputs +
    bf16 operator, f32 accumulation); its MFU against the bf16 spec peak is
    the tensor-core utilization number.  ``blocked`` is
    the two-level lane-major scan (r4) — the fastest exact-recursion path."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import MvLGSSM

    out = {}
    for d, Rm in ((4, 4096), (16, 1024)):
        m = MvLGSSM.from_arrays(
            A=0.9 * np.eye(d), Q=np.eye(d), H=np.eye(d), R=np.eye(d),
            m0=np.zeros(d), P0=np.eye(d),
        )
        key = jax.random.PRNGKey(d)
        ym = jax.block_until_ready(
            jnp.cumsum(jax.random.normal(key, (Rm, T, d), jnp.float32), 1)
        )
        from cortex_tpu.ops.chains_mv import (
            mv_lgssm_smooth_matmul,
            mv_lgssm_smoother_operator,
        )

        op = mv_lgssm_smoother_operator(
            T, m.A, m.Q, m.H, m.R, (m.m0, m.P0)
        )
        L_bf16 = op.L.astype(jnp.bfloat16)

        def mm_bf16(v, L, c, cov, d=d):
            flat = v.reshape(v.shape[:-2] + (T * d,)).astype(jnp.bfloat16)
            mean = (
                jnp.einsum(
                    "rk,kj->rj", flat, L,
                    preferred_element_type=jnp.float32,
                ).reshape(v.shape[:-2] + (T, d))
                + c
            )
            return mean, jnp.broadcast_to(cov, v.shape[:-2] + cov.shape)

        per_method = {}
        recursions = (("scan", K, 3), ("blocked", K, 3),
                      ("assoc", max(2, K // 16), 2))
        if d > 8:
            # The unrolled d^3 combine network of blocked/assoc: compiling
            # blocked at d=16 crashed the process on an H100 (PERF.md).
            recursions = recursions[:1]
        for method, Km, reps in recursions:
            fn = lambda v, meth=method: m.smooth(v, method=meth)
            med, stats = _sweep_stats(fn, ym, Km, repeats=reps)
            per_method[method] = (med, stats, fn, ())
        mm_fn = lambda v, o: mv_lgssm_smooth_matmul(v, operator=o)
        med, stats = _sweep_stats(mm_fn, ym, K, aux=(op,))
        per_method["matmul"] = (med, stats, mm_fn, (op,))
        med, stats = _sweep_stats(
            mm_bf16, ym, K, aux=(L_bf16, op.c, op.cov)
        )
        per_method["matmul_bf16"] = (med, stats, mm_bf16, (L_bf16, op.c, op.cov))

        best_method = min(per_method, key=lambda k: per_method[k][0])
        dt, _, best_fn, best_aux = per_method[best_method]
        flops = _flops_of(best_fn, ym, *best_aux)
        dt_bf16 = per_method["matmul_bf16"][0]
        flops_bf16 = _flops_of(mm_bf16, ym, L_bf16, op.c, op.cov)
        # The DEFAULT (method="auto") path must stay within 1.1x of the
        # best measured exact-recursion path at every d; matmul paths need
        # a precomputed operator, so the default competes among the
        # recursion paths.
        default = m.auto_method()
        best_rec = min(
            per_method[k][0] for k, _, _ in recursions
        )
        out[f"d{d}"] = {
            "replicas": Rm, "T": T,
            "sweep_us": {k: v[1] for k, v in per_method.items()},
            "best_method": best_method,
            "default_method": default,
            "default_vs_best_recursion": round(
                per_method[default][0] / best_rec, 2
            ),
            "xla_flops_per_sweep": flops,
            "achieved_tflops": round(flops / dt / 1e12, 2),
            "mfu_pct_of_bf16_peak": round(100 * flops / dt / 1e12 / matmul_peak, 2),
            "mfu_pct_bf16_edge_path": round(
                100 * flops_bf16 / dt_bf16 / 1e12 / matmul_peak, 2
            ),
            "note": "matmul_bf16 = the precision policy's bf16-edge config "
            "(bf16 operator+inputs, f32 accumulation; accuracy delta from "
            "benchmarks/precision_bench.py); blocked = two-level lane-major "
            "scan; assoc kept for the record (flat O(T log T) network)",
        }
    return out


def _ladder_hgf(K, hbm_peak):
    """Streaming HGF filtering: full-trajectory and trimmed-track kernel
    configs (opt-in tracks).  ``pct_hbm_peak`` is computed per config with
    that config's own traffic; ``pct_of_compute_floor`` quantifies the
    serial-recursion floor.

    The floor probe executes the EXACT per-step update (``HGF.step`` on
    (R, T) operand arrays, all element-steps data-parallel, XLA-fused, one
    input read) — the minimum time any schedule of the same R*T updates can
    take on this chip given the op mix.  The kernel runs the same updates
    with T-step serial dependence per replica; its distance from the probe
    is what serialization + layout actually cost."""
    import jax
    import jax.numpy as jnp

    from cortex_tpu.models import HGF, HGFState
    from cortex_tpu.ops.pallas_hgf import hgf_filter_pallas

    Rh, Th = 65536, 256
    key = jax.random.PRNGKey(9)
    uh = jax.block_until_ready(
        jnp.cumsum(0.1 * jax.random.normal(key, (Rh, Th), jnp.float32), -1)
    )
    hgf = HGF()

    def all5(method):
        def fn(data):
            final, traj = hgf.filter(data, method=method)
            return final, traj.mu1, traj.mu2
        return fn

    def filter_only(data):
        final, _ = hgf.filter(data, method="pallas", tracks=())
        return final

    def mu_bf16(data):
        final, tr = hgf_filter_pallas(
            data, tracks=("mu1", "mu2"), track_dtype=jnp.bfloat16
        )
        return final, tr

    def floor_probe(data):
        # One HGF step per element, fully parallel: same op mix, same input
        # read, no serial dependence, no trajectory writes (harness fuses
        # the output reduction).  Carries derived from data so nothing
        # constant-folds; pi1/pi2 kept positive.
        st = HGFState(
            data, 1.0 + data * data, 0.5 * data, 1.0 + jnp.abs(data)
        )
        new_state, delta1 = hgf.step(st, data)
        return tuple(new_state) + (delta1,)

    floor_t, floor_stats = _sweep_stats(floor_probe, uh, max(8, K))
    # (config, fn, f32-equivalent buffer count for traffic accounting)
    configs = {
        "scan": (all5("scan"), 6.0),
        "pallas": (all5("pallas"), 6.0),
        "pallas_filter_only": (filter_only, 1.0),
        "pallas_mu_bf16": (mu_bf16, 2.0),  # 1 f32 read + 2 bf16 writes
    }
    out_cfg = {}
    meds = {}
    for name, (fn, bufs) in configs.items():
        med, stats = _sweep_stats(fn, uh, K)
        meds[name] = med
        stats["pct_hbm_peak"] = round(
            100 * bufs * Rh * Th * 4 / med / 1e9 / hbm_peak, 1
        )
        stats["pct_of_compute_floor"] = round(100 * floor_t / med, 1)
        out_cfg[name] = stats
    dt = meds["pallas_filter_only"]
    return {
        "replicas": Rh, "T": Th,
        "sweep_us": out_cfg,
        "best_method": min(meds, key=meds.get),
        "compute_floor_us": floor_stats,
        # Headline = the streaming-filtering configuration (final state
        # only); trajectory configs are reported above.
        "obs_per_s": round(Rh * Th / dt, 1),
        "pct_hbm_peak": out_cfg["pallas_filter_only"]["pct_hbm_peak"],
        "pct_of_compute_floor": out_cfg["pallas_filter_only"][
            "pct_of_compute_floor"
        ],
        "note": "pct_of_compute_floor is the binding metric for the "
        "trimmed-track configs (serial recursion, ~1 buffer of traffic); "
        "pct_hbm_peak for the full-trajectory configs (6 buffers)",
    }


def bench_ladder(peaks, K=40):
    """Device times for the rest of the BASELINE.md model ladder: GMM
    structured VMP, MvLGSSM (d=4,16; MFU), streaming HGF, HMM+Dirichlet VMP
    (scan and Triton E-step).  Same timing as the primary metric."""
    hbm_peak = peaks["spec_hbm_GBps"]
    matmul_peak = peaks["spec_bf16_tflops"]
    return {
        "gmm": _section("ladder.gmm", _ladder_gmm, K, hbm_peak, matmul_peak),
        "mv_lgssm": _section("ladder.mv", _ladder_mv, K, matmul_peak),
        "hgf": _section("ladder.hgf", _ladder_hgf, K, hbm_peak),
        "hmm": _section("ladder.hmm", _ladder_hmm, K),
    }


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's default device is "
                 f"{jax.devices()[0].platform!r}")
    from chip_smoke import configure_compile_cache

    configure_compile_cache()
    replicas = 10_000
    peaks = _section("hw_peaks", bench_hw_peaks)
    print(f"[bench] card: {peaks['card']}", file=sys.stderr, flush=True)
    primary = _section("paths_10k", bench_paths, replicas, 400)
    scale = _section("paths_100k", bench_paths, 100_000, 100)
    generic_dt, generic_lowered, generic_scan_dt = _section(
        "generic_compiled", bench_generic_compiled, replicas, 200
    )
    generic_vmp = _section("generic_vmp", bench_generic_vmp, replicas, 40)
    generic_structured = _section(
        "generic_structured", bench_generic_structured, replicas, 4
    )
    from cortex_tpu.ops import lgssm_smooth_matmul, lgssm_smoother_operator

    op = lgssm_smoother_operator(T)
    mm_flops = _flops_of(
        lambda y: lgssm_smooth_matmul(y, operator=op), _make_data(replicas)
    )
    ladder = bench_ladder(peaks)

    probe = primary.pop("probe")["median_us"] * 1e-6
    probe_100k = scale.pop("probe")["median_us"] * 1e-6
    dt100k = min(s["median_us"] for s in scale.values()) * 1e-6
    best = min(primary, key=lambda k: primary[k]["median_us"])
    dt = primary[best]["median_us"] * 1e-6
    updates_per_sweep = replicas * (3 * T - 2)
    updates_per_s = updates_per_sweep / dt
    baseline_updates_per_s = bench_dynamic_engine(T)

    hbm_peak = peaks["spec_hbm_GBps"]
    matmul_peak = peaks["spec_bf16_tflops"]
    # Traffic model: read y, write mean and variance (three (R, T) f32
    # buffers); the probe moves the same three.
    bytes_per_sweep = 3 * replicas * T * 4
    result = {
        "metric": "lgssm_10k_replica_message_updates_per_sec_per_chip",
        "value": round(updates_per_s, 1),
        "unit": "msg_updates/s",
        "vs_baseline": round(updates_per_s / baseline_updates_per_s, 2),
        "detail": {
            "replicas": replicas,
            "T": T,
            "best_path": best,
            "sweeps_per_sec": round(1.0 / dt, 2),
            "sweep_device_us": primary,
            "sweep_device_us_100k_replicas": scale,
            "msg_updates_per_s_100k_replicas": round(
                100_000 * (3 * T - 2) / dt100k, 1
            ),
            "hardware": peaks,
            "roofline": {
                "bytes_per_sweep": bytes_per_sweep,
                "matched_traffic_probe_us": round(probe * 1e6, 1),
                "probe_GBps": round(bytes_per_sweep / probe / 1e9, 1),
                "pct_matched_probe_best": round(100.0 * probe / dt, 1),
                "pct_hbm_spec_peak_best": round(
                    100.0 * bytes_per_sweep / dt / 1e9 / hbm_peak, 1
                ),
                "mfu_pct_matmul_path": round(
                    100.0
                    * mm_flops
                    / (primary["matmul"]["median_us"] * 1e-6)
                    / 1e12
                    / matmul_peak,
                    2,
                ),
                "mfu_pct_matmul_bf16_path": round(
                    100.0
                    * mm_flops
                    / (primary["matmul_bf16"]["median_us"] * 1e-6)
                    / 1e12
                    / matmul_peak,
                    2,
                ),
                "traffic_model": "read y, write mean and variance: "
                "3*R*T*4 bytes per sweep; the probe moves the same",
                "probe_us_100k": round(probe_100k * 1e6, 1),
                "pct_matched_probe_best_100k": round(
                    100.0 * probe_100k / dt100k, 1
                ),
                "pct_hbm_spec_peak_best_100k": round(
                    100.0 * (3 * 100_000 * T * 4) / dt100k / 1e9 / hbm_peak,
                    1,
                ),
            },
            "generic_path": {
                    "sweep_device_us": round(generic_dt * 1e6, 1),
                    "chain_lowered_to_scan": generic_lowered,
                    "scan_same_section_us": round(generic_scan_dt * 1e6, 1),
                    "ratio_vs_scan": round(generic_dt / generic_scan_dt, 2),
                    "ratio_vs_best_handwritten": round(generic_dt / dt, 2),
                    "gap_decomposition": "ratio_vs_scan is executor overhead "
                    "on the same O(T) algorithm; the remaining gap to the "
                    "matmul path is algorithmic (affine-in-y (R,T)x(T,T) "
                    "operator, O(T^2)/replica, scalar-LGSSM-specific; see "
                    "PERF.md for the measured T-crossover)",
            },
            "generic_vmp": generic_vmp,
            "generic_structured": generic_structured,
            "ladder": ladder,
            "methodology": "jit, warm up, then rounds of K back-to-back "
            "calls each ended by block_until_ready; median per call",
            "baseline": "dynamic per-signal reactive engine (reference "
            "architecture), msg_updates/s",
            "baseline_value": round(baseline_updates_per_s, 1),
        },
    }
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent
    detail_path = repo / "BENCH_DETAIL.json"
    with open(detail_path, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    # Keep the docs' bench-generated regions in lockstep with the artifact
    # just written — tests/test_docs.py fails on any drift between the two.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_bench_docs", repo / "tools" / "gen_bench_docs.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for rel, new in mod.rendered_files(result).items():
        (repo / rel).write_text(new)
    print(json.dumps(_compact(result)))


def _compact(result):
    """The compact final stdout line: medians and headline ratios only;
    the full detail lives in BENCH_DETAIL.json."""

    def med(s):
        return s.get("median_us") if isinstance(s, dict) else None

    d = result["detail"]
    sweep = d.get("sweep_device_us", {})
    lad = d.get("ladder", {})
    gen_bp = d.get("generic_path", {})
    vmp = d.get("generic_vmp", {})
    struct = d.get("generic_structured", {})
    hmm, gmm = lad.get("hmm", {}), lad.get("gmm", {})
    mv, hgf = lad.get("mv_lgssm", {}), lad.get("hgf", {})

    def mv_row(key):
        row = mv.get(key, {}) if isinstance(mv, dict) else {}
        if not isinstance(row, dict) or "sweep_us" not in row:
            return row.get("error", "n/a") if isinstance(row, dict) else "n/a"
        return {
            "best": row.get("best_method"),
            "us": med(row["sweep_us"].get(row.get("best_method"), {})),
            "default": row.get("default_method"),
            "default_vs_best_recursion": row.get("default_vs_best_recursion"),
        }

    def hmm_iter(variant):
        return med(hmm.get("per_vmp_iter_us", {}).get(variant, {}))

    return {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "detail": {
            "best_path": d.get("best_path"),
            "sweeps_per_sec": d.get("sweeps_per_sec"),
            "sweep_device_us": {k: med(v) for k, v in sweep.items()},
            "msg_updates_per_s_100k": d.get("msg_updates_per_s_100k_replicas"),
            "pct_hbm_peak_best_100k": d.get("roofline", {}).get(
                "pct_hbm_spec_peak_best_100k"
            ),
            "generic": {
                "bp_ratio_vs_scan": gen_bp.get("ratio_vs_scan"),
                "vmp_ratio_vs_handwritten": vmp.get("ratio_vs_handwritten"),
                "structured_steady_iter_us": struct.get("steady_iter_us"),
                "structured_warm_us": struct.get("warm_start_sweep_us"),
            },
            "ladder": {
                "hmm_iter_us": {
                    "scan": hmm_iter("scan"),
                    "pallas": hmm_iter("pallas"),
                },
                "hmm_ratio_scan_over_pallas": hmm.get(
                    "ratio_scan_over_pallas"
                ),
                "gmm_iter_us": med(gmm.get("per_vmp_iter_us", {})),
                "gmm_binding": gmm.get("binding_resource"),
                "mv_d4": mv_row("d4"),
                "mv_d16": mv_row("d16"),
                "hgf_obs_per_s": hgf.get("obs_per_s"),
                "hgf_pct_of_compute_floor": hgf.get("pct_of_compute_floor"),
            },
            "card": d.get("hardware", {}).get("card"),
            "methodology": d.get("methodology"),
            "detail_file": "BENCH_DETAIL.json",
        },
    }


if __name__ == "__main__":
    main()
