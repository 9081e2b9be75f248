"""Streaming rig: cached maps + remap + matcher, against composed stages."""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_stereo_matching_tpu.calib.rectify import rectification_maps_from_calibration
from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.io.calib_yaml import StereoCalibration
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu.models.streaming import StereoRig
from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr
from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8
from gpu_stereo_matching_tpu.utils.cache import ArtifactCache


@pytest.fixture
def tiny_calib():
    k = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1.0]])
    return StereoCalibration(
        left_intrinsics=k,
        right_intrinsics=k * np.array([[1.02], [1.01], [1.0]]),
        left_distortion=np.array([0.01, -0.02, 0.0, 0.0, 0.0]),
        right_distortion=np.array([0.02, -0.01, 0.0, 0.0, 0.0]),
        rotation=np.eye(3),
        translation=np.array([-5.0, 0.0, 0.0]),
    )


def test_rig_matches_composed_stages(tmp_path, rng, tiny_calib):
    size_hw = (24, 32)
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    rig = StereoRig(
        tiny_calib, size_hw, cfg,
        cache=ArtifactCache(str(tmp_path)),
    )
    left = rng.integers(0, 256, size=(*size_hw, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(*size_hw, 3), dtype=np.uint8)
    got = np.asarray(rig.process(left, right))

    (lmx, lmy), (rmx, rmy) = rectification_maps_from_calibration(tiny_calib, size_hw)
    gl = gray_blockmatching_bgr(jnp.asarray(left))
    gr = gray_blockmatching_bgr(jnp.asarray(right))
    rl = remap_bilinear_u8(gl, jnp.asarray(lmx), jnp.asarray(lmy))
    rr = remap_bilinear_u8(gr, jnp.asarray(rmx), jnp.asarray(rmy))
    want = np.asarray(block_matching_pipeline(rl, rr, cfg))
    np.testing.assert_array_equal(got, want)


def test_rig_batch(tmp_path, rng, tiny_calib):
    size_hw = (16, 24)
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    rig = StereoRig(
        tiny_calib, size_hw, cfg,
        cache=ArtifactCache(str(tmp_path)),
    )
    lb = rng.integers(0, 256, size=(3, *size_hw, 3), dtype=np.uint8)
    rb = rng.integers(0, 256, size=(3, *size_hw, 3), dtype=np.uint8)
    batch = np.asarray(rig.process_batch(lb, rb))
    for i in range(3):
        single = np.asarray(rig.process(lb[i], rb[i]))
        np.testing.assert_array_equal(batch[i], single)


def test_map_cache_reused(tmp_path, tiny_calib):
    cache = ArtifactCache(str(tmp_path))
    cfg = BlockMatchingConfig(num_disparities=4, sad_radius=1)
    StereoRig(tiny_calib, (16, 24), cfg, cache=cache)
    import os

    files = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    assert len(files) == 1
    # Second rig with same calibration hits the cache (no new files).
    StereoRig(tiny_calib, (16, 24), cfg, cache=cache)
    files2 = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    assert files2 == files
