"""Test harness: an 8-device virtual CPU mesh before JAX initializes.

Every test sees 8 CPU devices by default, so `jax.sharding.Mesh`-based
code paths (distributed BA, pipelined stages) compile and execute the
same collectives they would across several cards. An explicitly chosen
platform (e.g. `JAX_PLATFORMS=cuda` for the `gpu`-marked tests) is let
through.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# compilation is the test-time bottleneck; persist compiled executables
# across pytest runs
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
