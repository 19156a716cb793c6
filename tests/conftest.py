"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding paths
can be exercised without accelerators (`shard_map` over a fake mesh).
Tests marked `gpu` need a GPU and skip elsewhere (the `gpu_only`
fixture decides at run time, so every xdist worker collects the same
tests); run them on the card with `ORC_TEST_PLATFORM=gpu python -m
pytest tests/ -m gpu`.
"""

import os

# Must be set before jax import. ORC_TEST_PLATFORM overrides the CPU
# default ("gpu" for the card-only tests; JAX names that backend
# "cuda", and an explicit "gpu" would also demand ROCm).
_platform = os.environ.get("ORC_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = "cuda" if _platform == "gpu" else _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from orc_cfd.backend import setup_compile_cache  # noqa: E402

# Persistent XLA compile cache for the suite (reruns skip most CPU
# compiles): JAX_COMPILATION_CACHE_DIR, or the checkout's default.
setup_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

REFERENCE_EXAMPLES = "/root/reference/examples"


@pytest.fixture(scope="session")
def reference_mesh_dir():
    if not os.path.isdir(REFERENCE_EXAMPLES):
        pytest.skip("reference example meshes not available")
    return REFERENCE_EXAMPLES


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with ORC_TEST_PLATFORM=gpu)")


@pytest.fixture(scope="session")
def small_box():
    """3x3x3 unit box, generated analytically."""
    from orc_cfd.mesh import structured_box_mesh

    return structured_box_mesh(3, 3, 3)


def assert_allclose(a, b, rtol=1e-12, atol=1e-12, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, **kw)
