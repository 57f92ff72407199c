"""Serving layer: AOT compilation, portable executables, bucketed batching.

The reference stops at a library API (no serving story,
`/root/reference/docs/src/index.md`); a production deployment needs three
more things, all XLA-shaped:

- **Ahead-of-time compilation** (:func:`aot_compile`): trace + lower + compile
  once at deploy time, so the first request doesn't pay the XLA compile.
  The wrapper exposes XLA's own FLOP/memory cost model for capacity
  planning.
- **Portable serialized executables** (:func:`export_serialized` /
  :func:`load_serialized`): `jax.export` StableHLO payloads that ship to a
  serving fleet without the Python model code (serializing needs the
  ``flatbuffers`` package).
- **Shape-bucketed serving** (:class:`BucketedServer`): ragged request
  batches are padded up to a small set of power-of-two buckets so XLA sees a
  handful of static shapes instead of one compile per batch size (XLA
  compiles static shapes only).

Plus :func:`enable_persistent_cache` to carry compiled artifacts across
process restarts.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "aot_compile",
    "export_serialized",
    "load_serialized",
    "enable_persistent_cache",
    "BucketedServer",
]


class CompiledFn:
    """An AOT-compiled callable with XLA's cost/memory introspection."""

    def __init__(self, compiled, in_tree_example):
        self._compiled = compiled
        self._example = in_tree_example

    def __call__(self, *args):
        return self._compiled(*args)

    def cost_analysis(self) -> dict:
        """XLA's static cost model (FLOPs, bytes accessed) — capacity
        planning without running anything."""
        c = self._compiled.cost_analysis()
        return c[0] if isinstance(c, (list, tuple)) else (c or {})

    def memory_analysis(self):
        """Compiled-program memory footprint (argument/output/temp bytes)."""
        return self._compiled.memory_analysis()

    def as_text(self) -> str:
        return self._compiled.as_text()


def aot_compile(fn: Callable, *example_args, static_argnums=()) -> CompiledFn:
    """Trace, lower and compile ``fn`` for the shapes/dtypes of
    ``example_args`` ahead of time.  The returned callable never retraces:
    calls must match the example structure (that is the point)."""
    jitted = jax.jit(fn, static_argnums=static_argnums)
    lowered = jitted.lower(*example_args)
    return CompiledFn(lowered.compile(), example_args)


def export_serialized(fn: Callable, *example_args) -> bytes:
    """Serialize ``fn`` (traced at the example shapes) to a portable
    StableHLO payload.  Deserialize with :func:`load_serialized` — on any
    machine with compatible devices, without the defining Python code."""
    from jax import export as jax_export

    specs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.shape(a), jnp.result_type(a)),
        example_args,
    )
    exported = jax_export.export(jax.jit(fn))(*specs)
    return exported.serialize()


def load_serialized(blob: bytes) -> Callable:
    """Rehydrate a payload from :func:`export_serialized` into a jittable
    callable."""
    from jax import export as jax_export

    exported = jax_export.deserialize(blob)
    return jax.jit(exported.call)


def enable_persistent_cache(path: str) -> None:
    """Persist XLA compilation artifacts under ``path`` so restarts (and
    sibling processes) skip recompilation.  Safe to call more than once —
    the process-global cache singleton is reset so the new directory takes
    effect even if a different one was active earlier in the process."""
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    try:
        from jax._src import compilation_cache as _cc

        _cc.reset_cache()
    except Exception:  # pragma: no cover - private API moved; dir still set
        pass


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket {buckets[-1]}")


class BucketedServer:
    """Pad ragged request batches onto a fixed ladder of compiled shapes.

    ``fn(batch, ...)`` must be batched over a leading axis of every array
    argument.  Requests of any size up to ``max_batch`` are padded up to the
    nearest power-of-two bucket (so at most ``log2(max_batch)+1`` distinct
    XLA programs exist), executed, and sliced back.  With
    ``precompile=True`` every bucket is AOT-compiled up front from the
    example arguments — zero compile latency at serve time.
    """

    def __init__(
        self,
        fn: Callable,
        example_args: Tuple[Any, ...],
        max_batch: int = 1024,
        min_bucket: int = 8,
        precompile: bool = False,
    ):
        self._fn = fn
        self.buckets = [
            1 << k
            for k in range(
                int(math.log2(min_bucket)), int(math.ceil(math.log2(max_batch))) + 1
            )
        ]
        self._compiled: dict[int, CompiledFn] = {}
        self._example = example_args
        if precompile:
            for b in self.buckets:
                self._get(b)

    @property
    def compiled_buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._compiled))

    def _pad(self, args, b: int):
        def pad_leaf(a):
            a = jnp.asarray(a)
            if a.shape[0] >= b:  # example larger than the bucket: slice down
                return a[:b]
            pad = [(0, b - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, pad)

        return jax.tree_util.tree_map(pad_leaf, args)

    def _get(self, b: int) -> CompiledFn:
        if b not in self._compiled:
            self._compiled[b] = aot_compile(self._fn, *self._pad(self._example, b))
        return self._compiled[b]

    def __call__(self, *args):
        n = jnp.shape(jax.tree_util.tree_leaves(args)[0])[0]
        b = _bucket_for(n, self.buckets)
        out = self._get(b)(*self._pad(args, b))
        return jax.tree_util.tree_map(lambda o: o[:n], out)
