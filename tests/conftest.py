"""Test configuration.

Tests run on the CPU with 8 virtual devices so multi-device sharding paths
can be exercised without accelerators (the reference's analogue of running
the same SPMD program on simulated devices; see SURVEY.md §4).  The Pallas
kernels run there in interpret mode.  ``jax.config.update`` pins the
platform, since a JAX imported earlier in the process would have latched the
environment variable already; XLA_FLAGS must be set before backend init.

Tests marked ``gpu`` need an NVIDIA GPU: they take the ``gpu`` fixture,
which skips when JAX has no GPU backend.  With ``CORTEX_TEST_GPU=1`` the
platform is left to JAX, so on a GPU host
``CORTEX_TEST_GPU=1 python -m pytest -m gpu tests/`` runs them on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("CORTEX_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not os.environ.get("CORTEX_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with CORTEX_TEST_GPU=1 on one)")
