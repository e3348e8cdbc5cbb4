"""Test configuration: an 8-device virtual CPU mesh unless told otherwise.

Multi-device sharding logic is exercised on virtual CPU devices
(xla_force_host_platform_device_count), the same mechanism the driver's
dryrun_multichip uses.  JAX_PLATFORMS defaults to cpu; tests marked `gpu`
run on the card with JAX_PLATFORMS=cuda (README "Testing").
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

from block_lanczos_tpu.utils.compile_cache import \
    enable_compile_cache  # noqa: E402

# persistent compilation cache: repeated test runs skip XLA recompiles
enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
