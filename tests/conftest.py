"""Test harness config: force an 8-device virtual CPU mesh BEFORE jax import.

Multi-device sharding tests run against ``xla_force_host_platform_device_count``
fakes; unit tests run on the CPU so the suite is hermetic. Tests marked
``gpu`` need an NVIDIA GPU and skip elsewhere; run them on a GPU host with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the CPU unless the run asked for the GPU platform explicitly (must
# happen before any backend is initialized). No persistent compile cache:
# every run compiles what it tests.
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found only " + devices[0].platform)
    return devices
