"""The fused SAD+WTA kernel in the Pallas interpreter vs. the oracles, and
the large-window median (the plain-XLA replacement of the former
histogram kernel) vs. the oracles."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.kernels.sad_wta import (
    fused_block_matching,
    fused_block_matching_key,
)
from gpu_stereo_matching_tpu.ops.postprocess import median_filter_u8
from tests import oracles


def _oracle_disparity(left, right, num_disp, radius):
    vol = oracles.ad_cost_volume_oracle(left, right, num_disp)
    sad = oracles.box_sum_oracle(vol, radius)
    return oracles.wta_oracle(sad)


def _pair(rng, shape):
    return (
        rng.integers(0, 256, size=shape, dtype=np.uint8),
        rng.integers(0, 256, size=shape, dtype=np.uint8),
    )


def test_fused_block_matching_interpret(rng):
    left, right = _pair(rng, (21, 33))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=8, radius=2, interpret=True,
            block_w=16, block_rows=8,
        )
    )
    np.testing.assert_array_equal(got, _oracle_disparity(left, right, 8, 2))


def test_fused_sad_values_match_ops_volume(rng):
    """The kernel's keys carry the exact clipped-window SAD of the XLA ops
    path (not only its argmin), at every border and in the x < d band."""
    from gpu_stereo_matching_tpu.ops.aggregate import aggregate_cost_volume
    from gpu_stereo_matching_tpu.ops.cost import ad_cost_volume

    for hw, d, r in [((21, 33), 8, 2), ((40, 150), 16, 3), ((37, 160), 64, 5)]:
        left, right = _pair(rng, hw)
        sad = np.asarray(
            aggregate_cost_volume(
                ad_cost_volume(jnp.asarray(left), jnp.asarray(right), d), r
            )
        )
        for dd in (0, d // 2, d - 1):
            keys = np.asarray(
                fused_block_matching_key(
                    jnp.asarray(left), jnp.asarray(right), dd, 1, d, r,
                    interpret=True, block_w=32, block_rows=16,
                )
            )
            np.testing.assert_array_equal(keys, sad[dd] * d + dd)


def test_fused_block_matching_tile_not_dividing(rng):
    left, right = _pair(rng, (13, 17))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=4, radius=1, interpret=True,
            block_w=8, block_rows=8,
        )
    )
    np.testing.assert_array_equal(got, _oracle_disparity(left, right, 4, 1))


def test_fused_batched_interpret(rng):
    left, right = _pair(rng, (2, 19, 22))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=8, radius=2, interpret=True,
            block_w=16, block_rows=8,
        )
    )
    for b in range(2):
        want = _oracle_disparity(left[b], right[b], 8, 2)
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize(
    "shape_d_r", [((9, 130), 4, 1), ((40, 64), 16, 3), ((16, 257), 12, 4)]
)
def test_fused_property_sweep(rng, shape_d_r):
    (h, w), num_d, radius = shape_d_r
    left, right = _pair(rng, (h, w))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=num_d, radius=radius, interpret=True,
            block_w=64, block_rows=8,
        )
    )
    np.testing.assert_array_equal(got, _oracle_disparity(left, right, num_d, radius))


def test_fused_disparity_chunks_combine(rng):
    """More disparities than one program's block: the chunks' keys reduce
    to the same WTA (ties to the smallest d across chunks)."""
    left, right = _pair(rng, (18, 40))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=20, radius=2, interpret=True,
            block_d=8, block_w=16, block_rows=8,
        )
    )
    np.testing.assert_array_equal(got, _oracle_disparity(left, right, 20, 2))


@pytest.mark.parametrize("num_d,radius", [(7, 2), (8, 6)])
def test_fused_legacy_fallback_paths(rng, num_d, radius):
    """Odd disparity counts (masked rows of the disparity block) and radii
    whose window is wider than the 16-column border block stay exact."""
    left, right = _pair(rng, (24, 40))
    got = np.asarray(
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right),
            num_disparities=num_d, radius=radius, interpret=True,
            block_w=16, block_rows=8,
        )
    )
    np.testing.assert_array_equal(got, _oracle_disparity(left, right, num_d, radius))


def test_fused_key_kernel_partial_ranges(rng):
    left, right = _pair(rng, (14, 20))
    num_d, radius = 8, 2
    keys_parts = []
    # Even, odd and straddling ranges must reduce to the same WTA.
    for d0, count in [(0, 4), (4, 4), (0, 3), (3, 5)]:
        keys = np.asarray(
            fused_block_matching_key(
                jnp.asarray(left), jnp.asarray(right), d0, count, num_d,
                radius, interpret=True, block_w=8, block_rows=8,
            )
        )
        keys_parts.append(keys)
    combined = np.minimum.reduce(keys_parts)
    np.testing.assert_array_equal(
        combined % num_d, _oracle_disparity(left, right, num_d, radius)
    )


def test_kernel_without_interpret_raises_off_gpu(rng):
    """The kernel lowers for CUDA only: on the CPU it refuses to run
    instead of quietly interpreting."""
    left, right = _pair(rng, (8, 16))
    with pytest.raises(Exception, match="interpret"):
        fused_block_matching(jnp.asarray(left), jnp.asarray(right), 4, 1)


def test_kernel_lowers_for_cuda():
    """Triton lowering of the full-size kernel succeeds without a card (the
    GPU compiler itself runs only on the card)."""
    x = jax.ShapeDtypeStruct((2, 1080, 1920), jnp.uint8)
    lowered = (
        jax.jit(lambda a, b: fused_block_matching(a, b, 64, 5))
        .trace(x, x)
        .lower(lowering_platforms=("cuda",))
    )
    assert "sad_wta" in lowered.as_text()


def test_key_overflow_rejected(rng):
    left, right = _pair(rng, (8, 300))
    with pytest.raises(ValueError, match="overflow"):
        fused_block_matching(
            jnp.asarray(left), jnp.asarray(right), 256, 100, interpret=True
        )


def _masked_median_oracle(x, r, valid):
    """Median of the valid pixels of each clipped window (0 if none)."""
    h, w = x.shape
    out = np.zeros_like(x)
    for y in range(h):
        for c in range(w):
            win = (slice(max(0, y - r), y + r + 1), slice(max(0, c - r), c + r + 1))
            v = np.sort(x[win][valid[win]])
            out[y, c] = v[len(v) // 2] if len(v) else 0
    return out


@pytest.mark.parametrize(
    "hw_r", [((20, 30), 1), ((33, 150), 4), ((40, 260), 7), ((16, 128), 9)]
)
def test_ctmf_median_matches_oracles(rng, hw_r):
    """The histogram-CDF median (CTMF analog, ctmf.c:98-339) is
    bit-identical to the sort median and to a direct oracle."""
    (h, w), r = hw_r
    x = rng.integers(0, 256, (h, w), dtype=np.uint8)
    got = np.asarray(median_filter_u8(jnp.asarray(x), r, method="histogram"))
    np.testing.assert_array_equal(
        got, np.asarray(median_filter_u8(jnp.asarray(x), r, method="sort"))
    )
    np.testing.assert_array_equal(got, oracles.median_oracle(x, r))


def test_ctmf_median_valid_mask(rng):
    h, w, r = 26, 140, 4
    x = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mask = rng.random((h, w)) > 0.3
    got = np.asarray(
        median_filter_u8(
            jnp.asarray(x), r, method="histogram", valid_mask=jnp.asarray(mask)
        )
    )
    np.testing.assert_array_equal(got, _masked_median_oracle(x, r, mask))


def test_ctmf_median_constant_and_extremes():
    x = jnp.full((17, 131), 255, jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(median_filter_u8(x, 4, method="histogram")), np.asarray(x)
    )
    z = jnp.zeros((17, 131), jnp.uint8)
    np.testing.assert_array_equal(
        np.asarray(median_filter_u8(z, 4, method="histogram")), np.asarray(z)
    )


def test_auto_median_picks_plain_xla_by_window_area(monkeypatch, rng):
    """``auto`` chooses sort or histogram by window area alone — never a
    kernel, whatever the image size or backend."""
    import gpu_stereo_matching_tpu.ops.postprocess as pp

    calls = []
    real = pp._median_u8_histogram
    monkeypatch.setattr(
        pp, "_median_u8_histogram",
        lambda *a, **k: calls.append("histogram") or real(*a, **k),
    )
    x = jnp.asarray(rng.integers(0, 256, (24, 40), dtype=np.uint8))
    pp.median_filter_u8(x, 3)
    assert calls == []
    pp.median_filter_u8(x, 4)
    assert calls == ["histogram"]
    with pytest.raises(ValueError):
        pp.median_filter_u8(x, 4, method="ctmf")
