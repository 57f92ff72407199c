"""Observability for the compiled path.

Inside ``jax.jit`` phases fuse into one XLA program, so per-phase value
snapshots are impossible there (SURVEY.md §5).  Two complementary tools:

- :func:`trace_run` — a *debug interpreter mode*: executes a
  :class:`~cortex_tpu.compile.CompiledInference` sweep eagerly, recording one
  :class:`TracedPhaseGroup` per batched rule call with wall time and
  (optionally) value snapshots — the compiled analogue of the dynamic
  engine's Request→Round→Execution tracer,
- :func:`profile_run` — wraps a call in a ``jax.profiler`` trace for real
  device timelines.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional

import jax

from ..utils import format_time_ns

__all__ = ["TracedPhaseGroup", "TracedSweep", "trace_run", "profile_run"]


class TracedPhaseGroup(NamedTuple):
    phase: int
    key: tuple
    n_steps: int
    wall_ns: int
    outputs: Optional[Any]  # stacked values if snapshots enabled


class TracedSweep(NamedTuple):
    groups: List[TracedPhaseGroup]
    total_ns: int
    marginals: Dict[int, Any]

    def __repr__(self) -> str:
        lines = [f"TracedSweep(total = {format_time_ns(self.total_ns)}, groups = ["]
        for g in self.groups:
            lines.append(
                f"  phase {g.phase}: {g.key[0]}/{g.key[1]} ×{g.n_steps} "
                f"in {format_time_ns(g.wall_ns)}"
            )
        lines.append("])")
        return "\n".join(lines)


def trace_run(
    compiled,
    inputs,
    state=None,
    *,
    snapshot_values: bool = False,
) -> TracedSweep:
    """Execute one sweep eagerly with per-group timing (debug interpreter
    mode — do not use for performance measurement)."""
    from .executor import tree_stack, tree_unstack

    values = compiled._resolve_inputs(inputs)
    if state is None:
        state = compiled.initial_state()
    for sig, val in zip(compiled.schedule.initials, state):
        values[id(sig)] = val

    groups_out: List[TracedPhaseGroup] = []
    t_start = time.perf_counter_ns()
    for p, phase in enumerate(compiled.schedule.phases):
        for group in phase:
            t0 = time.perf_counter_ns()
            n_deps = group.key[2]
            dep_values = [
                tree_stack([values[id(st.deps[j])] for st in group.steps])
                for j in range(n_deps)
            ]
            out = compiled.processor.dispatch(compiled.engine, group, dep_values)
            jax.block_until_ready(out)
            for st, val in zip(group.steps, tree_unstack(out, len(group.steps))):
                values[id(st.signal)] = val
            groups_out.append(
                TracedPhaseGroup(
                    p,
                    group.key,
                    len(group.steps),
                    time.perf_counter_ns() - t0,
                    out if snapshot_values else None,
                )
            )
    total_ns = time.perf_counter_ns() - t_start
    marginals = {
        vid: values[id(sig)] for vid, sig in compiled.schedule.targets.items()
    }
    return TracedSweep(groups_out, total_ns, marginals)


@contextlib.contextmanager
def profile_run(log_dir: str):
    """Record a ``jax.profiler`` trace of everything inside the block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
