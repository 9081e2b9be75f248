"""Test configuration: force an 8-device CPU platform before JAX loads.

Multi-chip sharding paths are exercised on a virtual CPU mesh (the
reference had no analog — its tests were single-GPU visual A/B, SURVEY §4).
The fused kernel runs here in the Pallas interpreter; its compiled form is
checked on a GPU by ``chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Force CPU, also on a machine with a GPU: set both the env var and the
# config, in case jax was imported before this file ran (the config update
# works until a backend is initialized).
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_jit_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


REFERENCE_ROOT = "/root/reference"


@pytest.fixture
def reference_images_root():
    root = os.path.join(REFERENCE_ROOT, "Images")
    if not os.path.isdir(root):
        pytest.skip("reference image assets not available")
    return root


@pytest.fixture
def reference_chess_root():
    root = os.path.join(REFERENCE_ROOT, "Chess")
    if not os.path.isdir(root):
        pytest.skip("reference chessboard captures not available")
    return root
