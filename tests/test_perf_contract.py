"""Performance-contract tests — the reference's allocation/optimality gates.

The reference pins two performance contracts inside its TEST suite:
``@allocated isa_variant(...) == 0`` and JET ``@test_opt`` on
``update_marginals!`` and the core signal ops
(``/root/reference/test/inference_engine_tests.jl:29-30,353-355``,
``test/signal_tests.jl:790-832,1084-1114``).  The Python/compiled analogues
:

1. **Zero-allocation hot ops on the native (C++) path** — ``is_pending`` /
   ``set_value`` / ``isa_variant`` on a ``NativeSignal`` must not allocate
   Python memory per call (the per-op state lives in the C++ core; the
   ctypes call returns interned bools / rebinds one attribute).
2. **Budget pins against the committed judge baseline** — the signal
   microbenchmark medians (``benchmarks/judge.py``, committed
   ``benchmarks/results/baseline.json``) must stay within 10x of the
   committed numbers.  10x is deliberately loose: the gate catches
   catastrophic regressions (an accidental O(n) scan in ``is_pending``,
   a quadratic listener walk) without flaking on machine differences;
   close-tolerance judging stays in ``make bench-judge`` (same-runner CI),
   mirroring the reference's 10%/5% PkgBenchmark tolerances.
"""

import gc
import json
import pathlib
import tracemalloc

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

from cortex_tpu.core.variants import IndividualMarginal
from cortex_tpu.native.bindings import NativeSignalEngine, load_native_lib

try:
    load_native_lib()
    HAVE_NATIVE = True
except Exception:  # pragma: no cover - toolchain-dependent
    HAVE_NATIVE = False

needs_native = pytest.mark.skipif(
    not HAVE_NATIVE, reason="native core not built (g++ unavailable?)"
)


def _traced_growth(op, n=2000):
    """Bytes of net Python allocation across n calls of op (warm)."""
    for _ in range(50):
        op()
    gc.collect()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for _ in range(n):
            op()
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return max(0, after - before)


@needs_native
def test_native_is_pending_zero_alloc():
    eng = NativeSignalEngine()
    s = eng.create_signal()
    dep = eng.create_signal()
    s.add_dependency(dep)
    dep.set_value(1.0)
    growth = _traced_growth(s.is_pending)
    # Interned-bool return: no per-op allocation.  Allow a small constant
    # slack for tracemalloc's own bookkeeping (not O(n)).
    assert growth < 2048, f"is_pending allocated {growth} bytes over 2000 calls"


@needs_native
def test_native_set_value_zero_alloc():
    eng = NativeSignalEngine()
    s = eng.create_signal()
    val = 0.5  # pre-existing object: set_value must only rebind + C call
    growth = _traced_growth(lambda: s.set_value(val))
    assert growth < 2048, f"set_value allocated {growth} bytes over 2000 calls"


@needs_native
def test_native_isa_variant_zero_alloc():
    """The reference's exact contract: @allocated isa_variant(...) == 0
    (``test/inference_engine_tests.jl:29-30``)."""
    eng = NativeSignalEngine()
    s = eng.create_inference_signal()
    s.set_variant(IndividualMarginal(variable_id=1))
    growth = _traced_growth(lambda: s.isa_variant(IndividualMarginal))
    assert growth < 2048, f"isa_variant allocated {growth} bytes"


# ---------------------------------------------------------------------------
# Budget pins vs the committed judge baseline.

DRIFT_FACTOR = 10.0
# The ops whose complexity class matters most: per-op core reads + the
# notification write path, at the largest committed size.
PINNED = [
    ("is_pending_n1000", "python"),
    ("is_computed_n1000", "python"),
    ("set_value_no_listeners_n1000", "python"),
    ("is_pending_n1000", "native"),
    ("set_value_no_listeners_n1000", "native"),
]


def _load_baseline():
    path = REPO / "benchmarks" / "results" / "baseline.json"
    if not path.exists():
        pytest.skip("no committed judge baseline")
    return json.loads(path.read_text())["results"]


@pytest.mark.parametrize("name,core", PINNED)
def test_budget_pin_vs_committed_baseline(name, core):
    import importlib.util
    import sys as _sys

    _sys.path.insert(0, str(REPO / "benchmarks"))
    spec = importlib.util.spec_from_file_location(
        "judge", REPO / "benchmarks" / "judge.py"
    )
    judge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(judge)
    from signal_bench import suite as build_suite

    baseline = _load_baseline()
    if core not in baseline or name not in baseline[core]:
        pytest.skip(f"{core}/{name} not in committed baseline")
    if core == "native" and not HAVE_NATIVE:
        pytest.skip("native core not built")
    if core == "python":
        from cortex_tpu import Signal as create
    else:
        create = NativeSignalEngine().create_signal
    bench_fns = build_suite(create)
    if name not in bench_fns:
        pytest.skip(f"{name} not in live suite")
    t = judge._best_time(bench_fns[name], repeat=3)
    budget = baseline[core][name]["time_s"] * DRIFT_FACTOR
    assert t <= budget, (
        f"{core}/{name}: {t * 1e6:.2f}us exceeds {DRIFT_FACTOR}x the "
        f"committed baseline ({baseline[core][name]['time_s'] * 1e6:.2f}us)"
    )
