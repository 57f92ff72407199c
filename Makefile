# Developer targets (parity with the reference's Makefile: test / benchmark /
# format / docs).

.PHONY: test test-fast lint format bench bench-save bench-judge native clean docs docs-html weak-scaling chip-smoke kernel-bench precision compiler-scale

test:
	python -m pytest tests/ -q -n 6

# Static-analysis gate (the reference's Aqua/JET analogue,
# test/runtests.jl:103-110): undefined names, unused imports, __all__
# hygiene (lint.py) + call-signature/annotation checking against runtime
# signatures (typecheck.py).  Zero findings required; also enforced by
# tests/test_lint.py and tests/test_typecheck.py.
lint:
	python tools/lint.py
	python tools/typecheck.py
	python tools/format.py

# Formatting contract alone (reference: scripts/formatter.jl via make format).
format:
	python tools/format.py

# On the GPU: the main path against float64 references (one card).
chip-smoke:
	python chip_smoke.py

# On the GPU: each Triton kernel against the XLA path it replaces.
kernel-bench:
	python benchmarks/kernel_bench.py

# f32-vs-bf16 accuracy study (CPU); prints the table as JSON.
precision:
	python benchmarks/precision_bench.py

# Front-end scale (build/extract/lower/jit to 10^5 signals); prints JSON rows.
compiler-scale:
	python benchmarks/compiler_scale_bench.py --full

test-fast:
	python -m pytest tests/ -q -x -k "not parallel and not chains_mv"

bench:
	python bench.py

# Regression judging (reference: scripts/bench.jl judge vs branch).
# Usage: make bench-save TAG=before ... make bench-judge TAG=after BASE=before
TAG ?= current
BASE ?= baseline
bench-save:
	python benchmarks/judge.py run --tag $(TAG)

bench-judge:
	python benchmarks/judge.py judge $(TAG) $(BASE)

native:
	g++ -O3 -std=c++17 -shared -fPIC \
	  -o cortex_tpu/native/_signal_core.so cortex_tpu/native/signal_core.cpp

docs:
	@ls docs/*.md

# Static HTML build of the docs (Documenter.jl analogue; no-pip renderer).
# The bench-generated regions are refreshed from BENCH_DETAIL.json first so
# rendered docs can never drift from the artifact of record.
docs-html:
	python tools/gen_bench_docs.py
	python tools/docs_build.py

# Weak-scaling curves on virtual devices; writes SCALING_r05.json.
weak-scaling:
	python benchmarks/weak_scaling_bench.py

clean:
	rm -rf cortex_tpu/native/_signal_core.so **/__pycache__ .pytest_cache
