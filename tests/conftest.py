"""Test configuration: run on the CPU with 8 virtual devices, so the
whole suite (sharded halo-exchange tests included) needs no GPU.  Tests
marked ``gpu`` take the ``gpu`` fixture, which skips them here.

Must set env vars before jax is imported anywhere.  On the card run the
GPU tests with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, never while
    modules are imported, so every worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no "
                    "interpret mode")
