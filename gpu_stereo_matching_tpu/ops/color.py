"""Color conversion and gradient ops (element-wise device work).

Semantics parity notes (vs. the reference):

* The reference has *two* gray conventions. The STMatching pipeline applies
  Rec.601 weights to BGR data correctly with round-half-up
  (``STMatching/StereoHelper.cpp:37``); the BlockMatching pipeline applies
  the (0.299, 0.587, 0.114) weights to the stored (B, G, R) channels in
  order — i.e. swapped — with round-to-nearest-even saturating u8
  (``BlockMatching/Device.cu:136-150``, ``Utility.cpp:289-298``). Both are
  provided; each pipeline uses its own convention.
* The x-gradient matches ``StereoHelper.cpp:56-70``: central difference
  halved in the interior, one-sided *unhalved* difference at the two border
  columns, plus a 127.5 offset.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp


def round_sat_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Round-to-nearest-even, saturate to [0, 255], cast to uint8.

    Matches the PTX ``cvt.rni.sat.u8.f32`` cast the reference uses on the GPU
    (``BlockMatching/Device.cu:145-150``).
    """
    return jnp.clip(jnp.rint(x), 0.0, 255.0).astype(jnp.uint8)


def grayscale_u8(
    img: jnp.ndarray,
    weights: Sequence[float],
    rounding: str = "half_up",
) -> jnp.ndarray:
    """Weighted channel sum of a (..., H, W, 3) uint8 image → (..., H, W) uint8.

    ``weights`` are applied to the stored channel order. ``rounding`` is
    ``"half_up"`` (float + 0.5 then truncate, the reference CPU convention)
    or ``"half_even"`` (round-to-nearest-even, the reference GPU convention).
    """
    w = jnp.asarray(weights, dtype=jnp.float32)
    gray = jnp.tensordot(img.astype(jnp.float32), w, axes=([-1], [0]))
    if rounding == "half_up":
        return jnp.clip(jnp.floor(gray + 0.5), 0.0, 255.0).astype(jnp.uint8)
    if rounding == "half_even":
        return round_sat_u8(gray)
    raise ValueError(f"unknown rounding mode: {rounding!r}")


def gray_rec601_bgr(img_bgr: jnp.ndarray) -> jnp.ndarray:
    """Proper Rec.601 luma of a BGR uint8 image (STMatching convention)."""
    return grayscale_u8(img_bgr, (0.114, 0.587, 0.299), rounding="half_up")


def gray_blockmatching_bgr(img_bgr: jnp.ndarray) -> jnp.ndarray:
    """BlockMatching-pipeline gray: Rec.601 weights applied to (B, G, R) in
    storage order (the reference's swapped convention, kept for parity with
    its own CPU/GPU pair; see ``Device.cu:140-142``)."""
    return grayscale_u8(img_bgr, (0.299, 0.587, 0.114), rounding="half_even")


def gradient_x(gray_u8: jnp.ndarray) -> jnp.ndarray:
    """Horizontal gradient of a (..., H, W) uint8 gray image → float32.

    Interior: ``0.5 * (g[x+1] - g[x-1]) + 127.5``. Border columns: one-sided
    full difference ``g[x±1] - g[x]`` style as in ``StereoHelper.cpp:56-70``
    (note the border difference is *not* halved).
    """
    g = gray_u8.astype(jnp.float32)
    left = g[..., :, :-2]
    right = g[..., :, 2:]
    interior = 0.5 * (right - left) + 127.5
    first = (g[..., :, 1:2] - g[..., :, 0:1]) + 127.5
    last = (g[..., :, -1:] - g[..., :, -2:-1]) + 127.5
    return jnp.concatenate([first, interior, last], axis=-1)
