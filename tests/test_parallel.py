"""Distributed pipeline on the virtual 8-device CPU mesh.

Gates: every mesh factorization of (data, space, disp) produces disparities
bit-identical to the single-device pipeline (halo exchange and the packed
min-argmin reduction must not change semantics).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig, MeshConfig
from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
from gpu_stereo_matching_tpu.parallel.mesh import build_mesh
from gpu_stereo_matching_tpu.parallel.stereo import (
    make_sharded_block_matching,
    shard_batch,
)


@pytest.fixture(autouse=True)
def _need_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.mark.parametrize(
    "mesh_shape",
    [(1, 1, 1), (2, 1, 1), (1, 4, 1), (1, 1, 4), (2, 2, 2), (1, 4, 2)],
)
def test_sharded_matches_single_device(rng, mesh_shape):
    data, space, disp = mesh_shape
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=2)
    b, h, w = 4, 24, 20
    left = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)
    right = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)

    mesh = build_mesh(MeshConfig(data=data, space=space, disp=disp))
    step = make_sharded_block_matching(mesh, cfg)
    jl, jr = shard_batch(mesh, jnp.asarray(left), jnp.asarray(right))
    got = np.asarray(step(jl, jr))

    want = np.asarray(block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    np.testing.assert_array_equal(got, want)


def test_uneven_disparity_split_rejected():
    mesh = build_mesh(MeshConfig(data=1, space=1, disp=4))
    with pytest.raises(ValueError):
        make_sharded_block_matching(mesh, BlockMatchingConfig(num_disparities=6))


@pytest.mark.parametrize("mesh_shape", [(1, 2, 2), (2, 1, 2)])
def test_sharded_pallas_kernel_matches(rng, mesh_shape):
    data, space, disp = mesh_shape
    cfg = BlockMatchingConfig(num_disparities=8, sad_radius=2)
    b, h, w = 2, 24, 20
    left = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)
    right = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)

    mesh = build_mesh(MeshConfig(data=data, space=space, disp=disp))
    step = make_sharded_block_matching(mesh, cfg, interpret=True)
    jl, jr = shard_batch(mesh, jnp.asarray(left), jnp.asarray(right))
    got = np.asarray(step(jl, jr))
    want = np.asarray(block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_shape", [(1, 1, 1), (1, 4, 1), (2, 2, 2), (1, 2, 4)])
def test_sharded_full_pipeline_matches(rng, mesh_shape):
    from gpu_stereo_matching_tpu.parallel.stereo import (
        make_sharded_block_matching_full,
    )

    data, space, disp = mesh_shape
    cfg = BlockMatchingConfig(
        num_disparities=8, sad_radius=2, lr_consistency=True, median_radius=2
    )
    b, h, w = 2, 24, 20
    left = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)
    right = rng.integers(0, 256, size=(b, h, w), dtype=np.uint8)

    mesh = build_mesh(MeshConfig(data=data, space=space, disp=disp))
    step = make_sharded_block_matching_full(mesh, cfg)
    jl, jr = shard_batch(mesh, jnp.asarray(left), jnp.asarray(right))
    got = np.asarray(step(jl, jr))
    want = np.asarray(block_matching_pipeline(jnp.asarray(left), jnp.asarray(right), cfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_space", [2, 4])
def test_sharded_st1_matches_tiled(rng, n_space):
    """Distributed ST-1 (one shard_map dispatch, per-band trees over the
    `space` axis) is bit-identical to the sequential tiled reference
    `st1_disparity_tiled` with the same band count."""
    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.models.segment_tree_tiled import (
        st1_disparity_tiled,
    )
    from gpu_stereo_matching_tpu.parallel.segment_tree import (
        st1_disparity_sharded,
    )

    cfg = SegmentTreeConfig(max_disp_levels=5, tau=90.0, min_size_seg=5)
    h, w = 8 * n_space, 18
    left = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    mesh = build_mesh(MeshConfig(data=1, space=n_space, disp=1))
    got = st1_disparity_sharded(left, right, mesh, cfg)
    want = st1_disparity_tiled(left, right, n_space, cfg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_space", [2, 4])
def test_sharded_st2_matches_tiled(rng, n_space):
    """Distributed ST-2 (two sharded dispatches + host tree rebuild) is
    bit-identical to the sequential tiled `st2_disparity_tiled` with the
    same band count (`StereoDisparity.cpp:91-159` semantics per band)."""
    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.models.segment_tree_tiled import (
        st2_disparity_tiled,
    )
    from gpu_stereo_matching_tpu.parallel.segment_tree import (
        st2_disparity_sharded,
    )

    cfg = SegmentTreeConfig(max_disp_levels=5, tau=90.0, min_size_seg=5)
    h, w = 8 * n_space, 18
    left = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    mesh = build_mesh(MeshConfig(data=1, space=n_space, disp=1))
    got = st2_disparity_sharded(left, right, mesh, cfg)
    want = st2_disparity_tiled(left, right, n_space, cfg)
    np.testing.assert_array_equal(got, want)


def test_sharded_st1_rejects_indivisible_height(rng):
    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.parallel.segment_tree import (
        st1_disparity_sharded,
    )

    cfg = SegmentTreeConfig(max_disp_levels=4, tau=90.0, min_size_seg=5)
    left = rng.integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    mesh = build_mesh(MeshConfig(data=1, space=4, disp=1))
    with pytest.raises(ValueError):
        st1_disparity_sharded(left, right, mesh, cfg)


def test_st2_tiled_matches_per_band_st2(rng):
    """ST-2 tiling: each band equals full ST-2 run on the band crop."""
    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.models.segment_tree import st2_disparity
    from gpu_stereo_matching_tpu.models.segment_tree_tiled import (
        st2_disparity_tiled,
    )

    cfg = SegmentTreeConfig(max_disp_levels=5, tau=90.0, min_size_seg=5)
    left = rng.integers(0, 256, size=(14, 16, 3), dtype=np.uint8)
    right = rng.integers(0, 256, size=(14, 16, 3), dtype=np.uint8)
    got = st2_disparity_tiled(left, right, 2, cfg)
    want = np.concatenate(
        [
            st2_disparity(left[:7], right[:7], cfg),
            st2_disparity(left[7:], right[7:], cfg),
        ],
        axis=0,
    )
    np.testing.assert_array_equal(got, want)
