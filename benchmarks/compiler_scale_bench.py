"""Compiler/builder cost at scale: graph build, schedule extraction, chain
lowering, and first-jit wall time at 10^3 / 10^4 / 10^5 signals.

Why: the reference's dynamic engine builds its graph in
Julia with O(1)-amortized per-edge cost and segment-tree resolvers
(``/root/reference/src/dependencies.jl``); our builder + ``extract_schedule``
are Python-object traversals, so production serving needs committed evidence
that they stay near-linear into the 10^5-signal regime.

Topologies (one per resolver regime):
- **chain**   — T latent steps (the lowering pass rerolls to ``lax.scan``,
  so first-jit cost must stay ~constant in T);
- **star**    — K observations on one variable (the >5-dependency segment-tree
  product path; one wide phase);
- **random tree** — mixed fan-in/fan-out (fuzz topology at scale).

For each: wall seconds for (build+resolve, extract_schedule, lower, jit+first
run on CPU), plus signals-per-second for the build+schedule front-end.

Usage: python benchmarks/compiler_scale_bench.py [--full]
  default scales stop at ~3x10^4 signals (CI-friendly); --full goes to 10^5.
"""

import json
import pathlib
import random as pyrandom
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _time(f):
    t0 = time.perf_counter()
    out = f()
    return out, time.perf_counter() - t0


def build_chain(T):
    from cortex_tpu import (
        BipartiteFactorGraph,
        Connection,
        Factor,
        InferenceEngine,
        Variable,
    )

    g = BipartiteFactorGraph()
    x = [g.add_variable(Variable(name="x", index=(i,))) for i in range(T)]
    y = [g.add_variable(Variable(name="y", index=(i,))) for i in range(T)]
    lik = [g.add_factor(Factor(functional_form="likelihood")) for _ in range(T)]
    for i in range(T):
        g.add_edge(y[i], lik[i], Connection(label="out"))
        g.add_edge(x[i], lik[i], Connection(label="out"))
    for i in range(T - 1):
        f = g.add_factor(Factor(functional_form="transition"))
        g.add_edge(x[i], f, Connection(label="out"))
        g.add_edge(x[i + 1], f, Connection(label="in"))
    return InferenceEngine(model_engine=g), x


def build_star(K):
    from cortex_tpu import (
        BipartiteFactorGraph,
        Connection,
        Factor,
        InferenceEngine,
        Variable,
    )

    g = BipartiteFactorGraph()
    p = g.add_variable(Variable(name="p"))
    for i in range(K):
        o = g.add_variable(Variable(name="o", index=(i,)))
        f = g.add_factor(Factor(functional_form="bernoulli"))
        g.add_edge(p, f, Connection(label="out"))
        g.add_edge(o, f, Connection(label="out"))
    return InferenceEngine(model_engine=g), [p]


def build_tree(N, seed=0):
    from cortex_tpu import (
        BipartiteFactorGraph,
        Connection,
        Factor,
        InferenceEngine,
        Variable,
    )

    rng = pyrandom.Random(seed)
    g = BipartiteFactorGraph()
    latents = [g.add_variable(Variable(name="z", index=(i,))) for i in range(N)]
    for i in range(1, N):
        parent = latents[rng.randrange(i)]
        f = g.add_factor(Factor(functional_form="link"))
        g.add_edge(parent, f, Connection(label="out"))
        g.add_edge(latents[i], f, Connection(label="in"))
    for i in range(N):
        o = g.add_variable(Variable(name="y", index=(i,)))
        f = g.add_factor(Factor(functional_form="obs"))
        g.add_edge(latents[i], f, Connection(label="out"))
        g.add_edge(o, f, Connection(label="out"))
    return InferenceEngine(model_engine=g), latents


def _rules(kind):
    import jax.numpy as jnp

    from cortex_tpu.compile import BatchedProcessor
    from cortex_tpu.dists import Beta, from_mean_variance

    if kind == "star":

        class Rules(BatchedProcessor):
            def compute_message_to_variable(self, engine, variants, dep_values):
                y = dep_values[0]
                return Beta(1.0 + y, 2.0 - y)

        return Rules()

    class Rules(BatchedProcessor):
        def compute_message_to_variable(self, engine, variants, dep_values):
            form = engine.get_factor(variants[0].factor_id).functional_form
            v = dep_values[0]
            if form in ("likelihood", "obs"):
                return from_mean_variance(v, jnp.ones_like(v))
            return from_mean_variance(v.mean, v.variance + 1.0)

    return Rules()


def measure(kind, size):
    import jax
    import jax.numpy as jnp

    from cortex_tpu.compile import CompiledInference
    from cortex_tpu.compile.lowering import lower_schedule
    from cortex_tpu.compile.schedule import extract_schedule

    builder = {"chain": build_chain, "star": build_star, "tree": build_tree}[kind]
    (engine, targets), t_build = _time(lambda: builder(size))
    schedule, t_sched = _time(lambda: extract_schedule(engine, targets))
    _, t_lower = _time(lambda: lower_schedule(schedule))
    compiled, t_ctor = _time(
        lambda: CompiledInference(engine, targets, _rules(kind))
    )

    from cortex_tpu.compile import smart_stack

    sources = compiled.schedule.sources
    data = jnp.arange(len(sources), dtype=jnp.float32) * 1e-3
    target_ids = list(compiled.schedule.targets)

    @jax.jit
    def sweep(arr):
        # Packed I/O: one stacked source pytree in, marginals re-fused into
        # one pack per family out — keeps trace cost O(rule groups), not
        # O(signals) (see compile/executor.py PackRef).
        marginals, _ = compiled.run({}, source_pack=arr, packed=True)
        stacked = smart_stack([marginals[v] for v in target_ids])
        leaves = jax.tree_util.tree_leaves(stacked)
        return sum(x.sum() for x in leaves)

    (_, t_jit) = _time(lambda: jax.block_until_ready(sweep(data)))
    n_signals = compiled.schedule.num_steps + len(sources)
    plan = compiled.plan
    return {
        "topology": kind,
        "size": size,
        "signals": n_signals,
        "phases": len(compiled.schedule.phases),
        "scan_segments": len(plan.scan_segments) if plan is not None else 0,
        "build_resolve_s": round(t_build, 3),
        "extract_schedule_s": round(t_sched, 3),
        "lower_s": round(t_lower, 3),
        "compiled_ctor_s": round(t_ctor, 3),
        "first_jit_s": round(t_jit, 3),
        "frontend_signals_per_s": round(n_signals / (t_build + t_ctor), 1),
    }


def main():
    full = "--full" in sys.argv
    import jax

    jax.config.update("jax_platforms", "cpu")

    chain_sizes = [333, 3_333] + ([33_333] if full else [])
    star_sizes = [500, 5_000] + ([50_000] if full else [])
    tree_sizes = [250, 2_500] + ([25_000] if full else [])

    rows = []
    for kind, sizes in (
        ("chain", chain_sizes),
        ("star", star_sizes),
        ("tree", tree_sizes),
    ):
        for size in sizes:
            row = measure(kind, size)
            rows.append(row)
            print(json.dumps(row), flush=True)

    out = {"metric": "compiler_scale", "platform": "cpu", "results": rows}
    print(json.dumps(out))
    repo = pathlib.Path(__file__).resolve().parents[1]
    (repo / "COMPILER_SCALE.json").write_text(json.dumps(out, indent=1))
    print(f"-> {repo / 'COMPILER_SCALE.json'}", file=sys.stderr)


if __name__ == "__main__":
    main()
