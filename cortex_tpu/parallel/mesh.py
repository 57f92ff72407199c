"""Device-mesh construction and sharding helpers.

The reference has no distributed runtime (SURVEY.md §2.3); scaling here is
SPMD over a `jax.sharding.Mesh`:

- ``replica`` axis: independent graph replicas (datasets / chains / particle
  sets) — pure data parallelism, collectives only for reductions,
- ``time`` axis: time-slices of long state-space chains across devices — the
  message-passing analogue of pipeline/sequence parallelism (see
  :mod:`cortex_tpu.parallel.time_sharded`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "replica_sharding",
    "shard_replicas",
    "P",
    "init_distributed",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-host JAX (`jax.distributed.initialize`) and return the
    global device count.

    Pass ``coordinator_address`` (e.g. ``"localhost:<port>"``),
    ``num_processes`` and ``process_id`` unless the cluster environment
    provides them.  After initialization, :func:`make_mesh` sees the global
    device set, with the ``replica`` axis naturally spanning hosts and inner
    axes spanning the devices of one host.  No-ops when already initialized
    or single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Already initialized (or single-process default backend): proceed.
        if "already initialized" not in str(e).lower():
            raise
    return len(jax.devices())


def make_mesh(
    axis_sizes: Optional[Sequence[Tuple[str, int]]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``axis_sizes`` is an ordered list of ``(axis_name, size)``; by default a
    1-D ``("replica", ndevices)`` mesh.  Use ``-1`` for one axis to absorb the
    remaining devices.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = [("replica", len(devices))]
    names = [name for name, _ in axis_sizes]
    sizes = [size for _, size in axis_sizes]
    if sizes.count(-1) > 1:
        raise ValueError("At most one axis may have size -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if len(devices) % known:
            raise ValueError(
                f"Cannot infer -1 axis: {len(devices)} devices not divisible "
                f"by {known}"
            )
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"Mesh needs {total} devices, only {len(devices)} present")
    mesh_devices = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(mesh_devices, tuple(names))


def replica_sharding(mesh: Mesh, axis: str = "replica") -> NamedSharding:
    """Sharding that splits the leading (replica) dimension over ``axis``."""
    return NamedSharding(mesh, P(axis))


def shard_replicas(x: jax.Array, mesh: Mesh, axis: str = "replica") -> jax.Array:
    """Place ``x`` with its leading axis sharded across ``axis``."""
    return jax.device_put(x, replica_sharding(mesh, axis))
