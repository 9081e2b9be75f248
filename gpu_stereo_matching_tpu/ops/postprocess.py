"""Post-processing: left-right consistency and median filtering.

* LR consistency matches ``STMatching/StereoDisparity.cpp:136-147``: a left
  pixel is *occluded/unstable* iff ``d == 0``, or ``x - d < 0``, or
  ``|d_L(x) - d_R(x - d)| > max_diff``.
* The median filter replaces the reference's CTMF (``STMatching/ctmf.c``)
  and its mislabeled ``MeanFilter`` wrapper (``Toolkit.cpp:33-48``). Small
  windows gather the (2r+1)² shifted window copies, sort along the window
  axis, and pick the per-pixel rank —
  windows are clipped at borders, so out-of-bounds slots carry a +∞
  sentinel and the rank is ``n//2 + 1`` with n the per-pixel valid count
  (the smallest value whose cumulative count exceeds n/2, the same median
  CTMF selects, ``ctmf.c:256-266``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.ops.aggregate import window_counts

_SENTINEL = 0x7FFF  # larger than any uint8 sample


def lr_consistency_mask(
    disp_left: jnp.ndarray,
    disp_right: jnp.ndarray,
    max_diff: int = 1,
) -> jnp.ndarray:
    """Stability mask for the left view (True = consistent, non-occluded).

    ``disp_left``/``disp_right`` are (H, W) integer disparity maps; the right
    map is sampled at ``x - d_L(x)``.
    """
    w = disp_left.shape[-1]
    x = jnp.arange(w)
    dl = disp_left.astype(jnp.int32)
    src = x[None, :] - dl
    in_range = src >= 0
    dr = jnp.take_along_axis(disp_right.astype(jnp.int32), jnp.clip(src, 0, w - 1), axis=-1)
    consistent = jnp.abs(dl - dr) <= max_diff
    return (dl > 0) & in_range & consistent


def median_filter_u8(
    x: jnp.ndarray,
    radius: int,
    method: str = "auto",
    valid_mask: "jnp.ndarray | None" = None,
) -> jnp.ndarray:
    """Median of clipped (2r+1)² windows of a (..., H, W) uint8 image → uint8.

    ``method``: ``"sort"`` stacks and sorts the (2r+1)² shifted window
    copies (best for small windows); ``"histogram"`` is a CTMF analog —
    a per-pixel histogram CDF built from 255 prefix-sum box filters with a
    running rank comparison, O(1) memory in the window size and O(1) work
    per pixel w.r.t. radius; ``"auto"`` picks by window area alone. Both
    are plain XLA and bit-identical.

    ``valid_mask`` (optional, (H, W) bool) marks pixels that exist; invalid
    pixels are excluded from every window exactly like out-of-image pixels
    (used by spatial shards whose halo rows extend past the global image).
    """
    if radius <= 0:
        return x
    if method == "auto":
        method = "sort" if (2 * radius + 1) ** 2 <= 49 else "histogram"
    if method not in ("sort", "histogram"):
        raise ValueError(f"unknown median method {method!r}")
    if method == "histogram":
        return _median_u8_histogram(x, radius, valid_mask)
    h, w = x.shape[-2], x.shape[-1]
    k = 2 * radius + 1
    xi = x.astype(jnp.int16)
    if valid_mask is not None:
        xi = jnp.where(valid_mask, xi, _SENTINEL)
    # Stack all k² shifted copies along a new leading window axis, padding
    # out-of-bounds with a sentinel so clipped windows sort it last.
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (radius, radius)]
    xp = jnp.pad(xi, pad, constant_values=_SENTINEL)
    windows = [
        xp[..., dy : dy + h, dx : dx + w] for dy in range(k) for dx in range(k)
    ]
    stack = jnp.stack(windows, axis=0)  # (k², ..., H, W)
    stack = jnp.sort(stack, axis=0)
    if valid_mask is None:
        n = window_counts((h, w), radius)  # (H, W)
    else:
        from gpu_stereo_matching_tpu.ops.aggregate import box_filter_sum

        n = box_filter_sum(valid_mask.astype(jnp.int32), radius)
    rank = (n // 2).astype(jnp.int32)  # index of the (n//2 + 1)-th smallest
    rank = jnp.broadcast_to(rank, stack.shape[1:])[None]
    med = jnp.take_along_axis(stack, rank, axis=0)[0]
    return med.astype(jnp.uint8)


def _median_u8_histogram(
    x: jnp.ndarray, radius: int, valid_mask: "jnp.ndarray | None" = None
) -> jnp.ndarray:
    """Histogram-CDF median: the data-parallel analog of CTMF (``ctmf.c``).

    CTMF slides two-tier column histograms with SIMD adds; here the CDF is
    evaluated densely — for each gray level v, a clipped box sum of the
    indicator ``x ≤ v`` gives the windowed CDF at v, and the median is the
    count of levels whose CDF is still below the rank. 255 separable
    prefix-sum box filters, fully vectorized, O(1) per pixel in the
    radius, constant memory. Invalid pixels (``valid_mask`` False) are
    excluded from both the CDF and the window count, exactly like
    out-of-image pixels.
    """
    from gpu_stereo_matching_tpu.ops.aggregate import box_filter_sum

    h, w = x.shape[-2], x.shape[-1]
    if valid_mask is None:
        n = window_counts((h, w), radius)
        valid_i = None
    else:
        valid_i = valid_mask.astype(jnp.int32)
        n = box_filter_sum(valid_i, radius)
    rank = (n // 2 + 1).astype(jnp.int32)

    def body(v, med):
        le = (x <= v.astype(x.dtype)).astype(jnp.int32)
        if valid_i is not None:
            le = le * valid_i
        cdf = box_filter_sum(le, radius)
        return med + (cdf < rank).astype(jnp.int32)

    med = jax.lax.fori_loop(
        0, 255, body, jnp.zeros(x.shape, jnp.int32), unroll=4
    )
    return med.astype(jnp.uint8)
