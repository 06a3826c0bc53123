"""Test configuration: force the CPU backend with 8 virtual devices.

Tests validate float64 numerics (the reference is NumPy f64 and the parity
target is 1e-10); the TPU fast path is exercised by bench.py on hardware.
The 8 virtual CPU devices back the multi-chip sharding tests.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# persistent compile cache: the 1-core suite is compile-dominated; cached
# binaries cut reruns substantially (env vars are not plumbed in this jax
# build — only jax.config.update works).  Kept separate from bench.py's
# .jax_cache: loading the suite's CPU AOT entries from a process with a
# different XLA:CPU backend config spams target-feature-mismatch errors.
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(os.path.dirname(
                      os.path.abspath(__file__))), ".jax_cache_tests"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import dgtpu  # noqa: E402,F401  (enables x64)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dgtpu.geometry import generate_rectangle_grid, write_plot3d  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT_DIR = os.path.join(REPO, "input")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy sharded/streamed/interpret tests — excluded from the "
        "fast lane (python -m pytest tests/ -q -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the port's CUDA kernels have no CPU "
        "mode); skipped where torch.cuda.is_available() is False")


@pytest.fixture(scope="session", autouse=True)
def ensure_grids():
    """Generate the rectangle grid inputs used across the suite."""
    os.makedirs(INPUT_DIR, exist_ok=True)
    for n in (1, 2, 4, 8):
        for p in (1, 2, 5):
            path = os.path.join(INPUT_DIR, f"Rectangle_{n}X{n}_nPoly{p}.xyz")
            if not os.path.exists(path):
                write_plot3d(path, *generate_rectangle_grid(n, n, p))
    yield


@pytest.fixture()
def base_settings():
    from dgtpu.settings import Settings, load_params
    s = Settings(load_params())
    s.update_setting("visualization.automatically_open_paraview", False)
    s.update_setting("visualization.export", False)
    s.update_setting("caching.enabled", False)
    s.update_setting("logging.loglevel", "WARNING")
    return s
