"""Test harness: an 8-device virtual CPU platform unless told otherwise.

Multi-device sharding is validated on a fake CPU mesh
(``xla_force_host_platform_device_count=8``), per SURVEY.md section 4.  This
must run before jax initializes its backends, hence the env mutation at
import time.  ``JAX_PLATFORMS`` is respected when set: the tests marked
``gpu`` run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

and skip everywhere else (the ``gpu_device`` fixture decides, at run time).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from edrl.device import enable_compile_cache  # noqa: E402

# The heavy tests (tiny-model fit/ensemble/eval programs) are compile-bound
# on CPU; repeat suite runs hit the persistent cache.
enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a CUDA device; JAX runs on {device.platform} here")
    return device
