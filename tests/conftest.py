"""Test configuration: force an 8-device virtual CPU mesh.

All tests run on CPU (fast, deterministic); multi-chip sharding tests use the
8 virtual devices. The real-TPU path is exercised by bench.py / the driver.

Note: a pytest plugin imports jax before this conftest runs, so env vars alone
are too late — the jax.config updates below take effect as long as no backend
has been initialized yet.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none"
    )
