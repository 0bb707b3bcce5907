"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU: sharding tests use
``--xla_force_host_platform_device_count=8`` virtual devices, and the GPU
kernel runs in Pallas interpret mode. Tests that need a real card carry
the ``gpu`` marker and skip without one; ``python chip_smoke.py`` drives
the whole path on the card.
"""

import os

# Must be set before jax is imported anywhere. CPU unless the caller
# names the platforms (on the card: JAX_PLATFORMS=cuda,cpu ... -m gpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

from realtimepathtracingresearchframework_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else
# <repo>/.jax_cache): renderer tests build scene-capturing jit closures
# per Renderer instance; identical programs hit the cache across tests
# and across runs instead of recompiling.
enable_compile_cache()

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _ensure_native_built() -> None:
    """Build native/librptr_native.so if a toolchain is available, so the
    ctypes fast path is tested rather than silently skipped (the analogue
    of the reference building ext/libvkr into every configuration)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = os.path.join(repo, "native", "build", "librptr_native.so")
    src = os.path.join(repo, "native", "vkr_decode.cpp")
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return
    try:
        subprocess.run(
            ["cmake", "-S", os.path.join(repo, "native"), "-B",
             os.path.join(repo, "native", "build"), "-G", "Ninja"],
            check=True, capture_output=True, timeout=120,
        )
        subprocess.run(
            ["cmake", "--build", os.path.join(repo, "native", "build")],
            check=True, capture_output=True, timeout=300,
        )
    except Exception:
        pass  # no toolchain: test_native.py keeps its skip marker


_ensure_native_built()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy end-to-end render (deselected by default on the "
        "1-CPU CI box; run with RPTR_RUN_SLOW=1 for the full suite)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a real GPU (compiled kernels); skips without one "
        "through the ``gpu_device`` fixture",
    )


def pytest_collection_modifyitems(config, items):
    """Keep the default run under ~5 min on the 1-CPU CI box: the
    heaviest end-to-end renders (~25 tests, ~8 min of XLA CPU compiles)
    only run with RPTR_RUN_SLOW=1. Every kernel/feature keeps a fast
    guard in the default set; the slow set re-renders them at full
    pipeline depth."""
    if os.environ.get("RPTR_RUN_SLOW", "") not in ("", "0"):
        return
    deselected = [i for i in items if "slow" in i.keywords]
    if deselected:
        config.hook.pytest_deselected(items=deselected)
        items[:] = [i for i in items if "slow" not in i.keywords]


@pytest.fixture
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def gpu_device():
    """The first GPU, or skip. Decided here, at run time, never at import
    or collection, so every xdist worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
