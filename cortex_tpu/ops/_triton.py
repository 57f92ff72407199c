"""Launch plumbing shared by the Pallas kernels (Triton route, NVIDIA GPU).

Every kernel in this package is one program per block of replicas with the
whole time recursion inside the program: the replicas are independent, the
recursion is sequential, and a ``lax.scan`` over time would launch at least
one device kernel per step.  Blocks hold tens of replicas so that a grid of
a few thousand replicas already puts blocks on every streaming multiprocessor.
"""

from __future__ import annotations

import jax

__all__ = ["resolve_interpret", "replica_tile", "next_pow2", "TARGET_BLOCKS"]

# Enough blocks for two per streaming multiprocessor on a 132-SM card; below
# that, smaller blocks buy more parallelism at the same per-block latency.
TARGET_BLOCKS = 264


def resolve_interpret(interpret: bool, name: str) -> bool:
    """The kernel runs compiled on a GPU, or interpreted when asked.

    There is no silent fallback: off a GPU, ``interpret=True`` must be
    passed explicitly (the CPU tests do), otherwise this raises.
    """
    if interpret:
        return True
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"{name} is a GPU kernel (Pallas, Triton route) and the default "
            f"device is {platform!r}; pass interpret=True to run it in the "
            "Pallas interpreter, or use the plain XLA path"
        )
    return False


def next_pow2(n: int) -> int:
    """The smallest power of two ``>= n`` (Triton block dimensions)."""
    return 1 << max(0, int(n) - 1).bit_length()


def replica_tile(n: int, lo: int, hi: int) -> int:
    """Power-of-two replica block in ``[lo, hi]``: the largest that still
    yields :data:`TARGET_BLOCKS` blocks for ``n`` replicas."""
    tile = 1 << max(0, (n // TARGET_BLOCKS).bit_length() - 1)
    return max(lo, min(hi, tile))
