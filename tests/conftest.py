"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding/vmap equivalence tests need several devices; the CPU backend
provides them. The GPU path is exercised by ``chip_smoke.py`` on the card.
"""
import os

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Persistent compilation cache: repeat test runs skip XLA compilation.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", os.path.join(os.path.dirname(__file__), ".jax_cache")
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
