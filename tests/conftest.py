"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; the program runs on the GPU through
``chip_smoke.py``.  Sharding tests use ``xla_force_host_platform_device_count``
per SURVEY.md §4's implication (multi-host tests via multi-device CPU
simulation).  The platform is switched through ``jax.config``, which works
any time before the first backend initialization, whatever the
environment says.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    # fail fast if the platform override didn't take
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
