"""Window cost aggregation as prefix-sum box filters.

The reference aggregates SAD windows with a naive O(w²) per-pixel loop
(``BlockMatching/Device.cu:43-56``). The data-parallel formulation is a
separable clipped-window box sum built from two exclusive prefix sums
(integral images) — O(1) per pixel per disparity, fully vectorized, and
exact in int32. This is the plain XLA reference; the fused kernel
(``kernels/sad_wta.py``) computes the same sums without writing a volume.

Window semantics: windows are clipped at the image border and only
in-bounds pixels contribute (the reference's boundary-skip,
``Device.cu:47-52``). No normalization — raw sums, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp


def _box1d_sum(x: jnp.ndarray, radius: int, axis: int) -> jnp.ndarray:
    """Clipped-window running sum of length ``2r+1`` along ``axis``."""
    if radius <= 0:
        return x
    n = x.shape[axis]
    if jnp.issubdtype(x.dtype, jnp.integer) or x.dtype == jnp.bool_:
        x = x.astype(jnp.int32)
    c = jnp.cumsum(x, axis=axis)  # inclusive prefix sum
    idx = jnp.arange(n)
    hi = jnp.clip(idx + radius, 0, n - 1)
    lo = idx - radius - 1
    take_hi = jnp.take(c, hi, axis=axis)
    take_lo = jnp.take(c, jnp.clip(lo, 0, n - 1), axis=axis)
    # Zero out the low term where the window touches the left edge.
    shape = [1] * x.ndim
    shape[axis] = n
    mask = (lo >= 0).reshape(shape)
    return take_hi - jnp.where(mask, take_lo, jnp.zeros_like(take_lo))


def box_filter_sum(
    x: jnp.ndarray,
    radius: int,
    axes: Sequence[int] = (-2, -1),
) -> jnp.ndarray:
    """Separable clipped-window box sum over ``axes`` (default: H, W)."""
    out = x
    for ax in axes:
        out = _box1d_sum(out, radius, ax)
    return out


def window_counts(shape: Tuple[int, int], radius: int) -> jnp.ndarray:
    """Number of in-bounds pixels in each clipped (2r+1)² window → (H, W) int32."""
    h, w = shape
    ch = _box1d_sum(jnp.ones((h, 1), jnp.int32), radius, 0)
    cw = _box1d_sum(jnp.ones((1, w), jnp.int32), radius, 1)
    return ch * cw


def aggregate_cost_volume(cost: jnp.ndarray, radius: int) -> jnp.ndarray:
    """SAD aggregation of a (..., D, H, W) cost volume over (2r+1)² windows.

    uint8 inputs are promoted to int32 so the aggregation is exact (float32
    integral images would lose integer exactness past 2²⁴).
    """
    return box_filter_sum(cost, radius, axes=(-2, -1))
