"""Bilinear remap (``ops/remap.py``, XLA's gather) vs. the NumPy oracle on
the warps a calibrated rig produces.

Maps are constructed with fractional parts away from exact .5 so results
must be *bit-identical*: at an exact-half rounding boundary a 1-ulp FMA
difference between backends may legally flip round-to-nearest-even by one
gray level (the reference's CPU/GPU remap pair has the same looseness).
"""

import numpy as np

import jax.numpy as jnp

from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8
from tests import oracles


def _grids(h, w):
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float32),
        np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    return yy, xx


def _check_exact(src, mx, my):
    got = np.asarray(
        remap_bilinear_u8(jnp.asarray(src), jnp.asarray(mx), jnp.asarray(my))
    )
    np.testing.assert_array_equal(got, oracles.remap_oracle(src, mx, my))
    return got


def test_planned_remap_smooth_warp(rng):
    h, w = 96, 200
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = _grids(h, w)
    mx = (xx + 5.3 * np.sin(yy / 31.0) + 0.1).astype(np.float32)
    my = (yy + 2.1 * np.cos(xx / 53.0) - 1.7).astype(np.float32)
    _check_exact(src, mx, my)


def test_planned_remap_out_of_bounds_regions(rng):
    h, w = 96, 200
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = _grids(h, w)
    mx = (xx - 12.3 + 5.3 * np.sin(yy / 31.0)).astype(np.float32)
    my = (yy + 8.2 + 2.1 * np.cos(xx / 53.0)).astype(np.float32)
    got = _check_exact(src, mx, my)
    # The left strip really is invalid and outputs 0.
    assert (got[:, :5] == 0).all()


def test_planned_remap_identity(rng):
    h, w = 40, 136
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = _grids(h, w)
    got = _check_exact(src, xx.astype(np.float32), yy.astype(np.float32))
    # Strict border rule: the last row and column sample out of bounds.
    np.testing.assert_array_equal(got[:-1, :-1], src[:-1, :-1])
    assert (got[-1] == 0).all() and (got[:, -1] == 0).all()


def test_planned_remap_random_jitter(rng):
    h, w = 64, 144
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = _grids(h, w)
    mx = (xx + rng.uniform(-3, 3, (h, w)) * 0.99 + 0.005).astype(np.float32)
    my = (yy + rng.uniform(-3, 3, (h, w)) * 0.99 + 0.005).astype(np.float32)
    _check_exact(src, mx, my)


def test_planned_remap_output_size_differs(rng):
    h, w = 48, 160
    src = rng.integers(0, 256, (h, w), dtype=np.uint8)
    oh, ow = 32, 96
    yy, xx = _grids(oh, ow)
    mx = (xx * 1.3 + 3.17).astype(np.float32)
    my = (yy * 1.1 + 2.23).astype(np.float32)
    _check_exact(src, mx, my)
