"""cortex_tpu — a compiled reactive message-passing Bayesian inference framework.

A from-scratch re-design of the capabilities of ReactiveBayes/Cortex.jl for
accelerators through JAX (XLA, Pallas kernels, sharded meshes); it runs on
an NVIDIA GPU:

- :mod:`cortex_tpu.core` — the reactive signal substrate, factor-graph model
  spec, dependency resolvers (BP / mean-field / structured VMP), and the
  dynamic inference engine with tracing (reference-parity path),
- :mod:`cortex_tpu.dists` — exponential-family message algebra as batched
  JAX pytrees,
- :mod:`cortex_tpu.compile` — static schedule compiler: dependency DAG →
  topologically-phased, type-batched XLA programs,
- :mod:`cortex_tpu.ops` — batched update rules and Pallas kernels,
- :mod:`cortex_tpu.models` — model families (Beta-Bernoulli, LGSSM, HMM,
  GMM, HGF),
- :mod:`cortex_tpu.parallel` — device-mesh sharding, collectives, streaming,
- :mod:`cortex_tpu.viz` — dependency-graph rendering (DOT),
- :mod:`cortex_tpu.checkpoint` — posterior-state save/restore,
- :mod:`cortex_tpu.serve` — AOT compilation, portable executables, bucketed
  batch serving.
"""

__version__ = "0.1.0"

from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

# Submodules load lazily (PEP 562) so `import cortex_tpu` stays light — the
# dynamic reactive core has no JAX dependency; the compute-path modules pull
# in JAX on first access.
_SUBMODULES = (
    "checkpoint",
    "compile",
    "diag",
    "dists",
    "models",
    "ops",
    "parallel",
    "serve",
    "utils",
    "viz",
    "native",
)

__all__ = list(_core_all) + ["__version__"] + list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
