"""Test config: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding tests use
xla_force_host_platform_device_count (SURVEY.md §7.1 item 7). Must run before
jax is imported anywhere.
"""

import os

# the suite runs on the CPU. Tests that need a GPU are marked `gpu` and
# decide inside the `gpu_device` fixture whether one exists; run them on a
# card with NN_BVH_TEST_DEVICE=gpu, which leaves JAX's platform choice alone
ON_GPU = os.environ.get("NN_BVH_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# persistent compile cache: repeat suite runs skip XLA compilation entirely
# (the dominant cost of these tests on a 2-core box)
import sys as _sys  # noqa: E402

_sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from nn_bvh.utils.cache import enable_jax_cache  # noqa: E402

enable_jax_cache()
# tests compile many small waves; cache them all (the util default of 10s
# only catches the big ones)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

assert ON_GPU or jax.devices()[0].platform == "cpu", \
    "the test suite runs on the CPU"


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX sees none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; JAX sees none")
    return gpus[0]
