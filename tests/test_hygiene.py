"""Package hygiene gates — the analogue of the reference's Aqua checks
(`test/runtests.jl:103-110`): every module imports, __all__ names exist,
public callables have docstrings."""

import importlib
import inspect
import pkgutil

import pytest

import cortex_tpu

MODULES = [
    "cortex_tpu",
    "cortex_tpu.core",
    "cortex_tpu.core.signal",
    "cortex_tpu.core.variants",
    "cortex_tpu.core.model_engine",
    "cortex_tpu.core.graph",
    "cortex_tpu.core.resolvers",
    "cortex_tpu.core.engine",
    "cortex_tpu.dists",
    "cortex_tpu.compile",
    "cortex_tpu.compile.schedule",
    "cortex_tpu.compile.executor",
    "cortex_tpu.compile.tracing",
    "cortex_tpu.ops",
    "cortex_tpu.ops.chains",
    "cortex_tpu.ops.chains_mv",
    "cortex_tpu.ops.hmm",
    "cortex_tpu.ops.free_energy",
    "cortex_tpu.ops.pallas_kernels",
    "cortex_tpu.ops.pallas_hmm",
    "cortex_tpu.ops.pallas_hgf",
    "cortex_tpu.ops.nonlinear",
    "cortex_tpu.ops.ep",
    "cortex_tpu.ops.cvi",
    "cortex_tpu.ops.gabp",
    "cortex_tpu.ops.hmc",
    "cortex_tpu.ops.sqrt_kalman",
    "cortex_tpu.ops.robust",
    "cortex_tpu.models",
    "cortex_tpu.parallel",
    "cortex_tpu.utils",
    "cortex_tpu.viz",
    "cortex_tpu.checkpoint",
    "cortex_tpu.diag",
    "cortex_tpu.native",
    "cortex_tpu.serve",
]


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_and_exports_exist(name):
    mod = importlib.import_module(name)
    for export in getattr(mod, "__all__", []):
        assert hasattr(mod, export), f"{name}.__all__ lists missing {export!r}"


@pytest.mark.parametrize("name", MODULES)
def test_public_api_documented(name):
    mod = importlib.import_module(name)
    assert mod.__doc__, f"{name} has no module docstring"
    for export in getattr(mod, "__all__", []):
        obj = getattr(mod, export)
        if inspect.isclass(obj) or inspect.isfunction(obj):
            assert obj.__doc__, f"{name}.{export} has no docstring"


def test_no_unexpected_top_level_modules():
    found = {
        m.name
        for m in pkgutil.iter_modules(cortex_tpu.__path__)
        if not m.name.startswith("_")
    }
    expected = {
        "core",
        "dists",
        "compile",
        "ops",
        "models",
        "parallel",
        "utils",
        "viz",
        "checkpoint",
        "diag",
        "native",
        "serve",
    }
    assert found == expected, f"Unexpected/missing submodules: {found ^ expected}"
