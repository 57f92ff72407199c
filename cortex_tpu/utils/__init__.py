"""Small shared utilities (reference ``/root/reference/src/utils.jl``)."""

from __future__ import annotations

import functools

import jax

__all__ = ["format_time_ns", "float32_matmuls"]


def float32_matmuls(fn):
    """Trace ``fn`` with every default-precision matmul in full float32.

    On a GPU, XLA may run a float32 ``dot`` in TF32, which keeps about three
    decimal digits: enough to move a d x d Kalman recursion's means by 4e-4
    of their scale.  Explicit ``precision=`` arguments inside ``fn`` win.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def format_time_ns(t: float) -> str:
    """Format a nanosecond duration as a human-readable string
    (reference ``src/utils.jl:3-17``)."""
    t = float(t)
    if t < 1_000:
        return f"{t:.0f}ns"
    if t < 1_000_000:
        return f"{t / 1_000:.2f}μs"
    if t < 1_000_000_000:
        return f"{t / 1_000_000:.2f}ms"
    if t < 60 * 1_000_000_000:
        return f"{t / 1_000_000_000:.2f}s"
    if t < 3600 * 1_000_000_000:
        return f"{t / (60 * 1_000_000_000):.2f}min"
    return f"{t / (3600 * 1_000_000_000):.2f}hr"
