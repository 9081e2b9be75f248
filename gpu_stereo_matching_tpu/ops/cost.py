"""Matching-cost volume construction.

Layout: cost volumes are ``(D, H, W)`` (or ``(B, D, H, W)`` batched) with W
the contiguous minor axis, so every per-disparity plane is a contiguous
2-D array and the WTA reduction is a major-axis reduction.

Two cost families, mirroring the reference:

* absolute-difference volume on gray images — the BlockMatching cost init
  (``BlockMatching/Device.cu:19-32``, CPU twin ``BlockMatching.cpp:40-47``),
* truncated color + gradient cost — the STMatching cost
  (``STMatching/StereoHelper.cpp:75-126``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import CostConstants
from gpu_stereo_matching_tpu.ops.color import gradient_x


def _shifted_right(right: jnp.ndarray, num_disparities: int) -> jnp.ndarray:
    """``right[..., x - d]`` (clamped at the left edge) → (D, ..., W).

    The clamp implements the reference's left-edge column replication
    (``StereoHelper.cpp:102-111``); callers that need out-of-range marking
    mask with ``x >= d`` themselves.

    D is static, so this is one edge-replicating pad plus D STATIC slices,
    which XLA fuses into the consumer instead of running a gather.
    """
    w = right.shape[-1]
    if num_disparities == 1:
        return right[None]
    pad = jnp.broadcast_to(
        right[..., :1], right.shape[:-1] + (num_disparities - 1,)
    )
    padded = jnp.concatenate([pad, right], axis=-1)
    base = num_disparities - 1
    return jnp.stack(
        [padded[..., base - d : base - d + w] for d in range(num_disparities)],
        axis=0,
    )


def ad_cost_volume(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    num_disparities: int,
    invalid_cost: int = 255,
) -> jnp.ndarray:
    """Per-disparity absolute difference of two (H, W) uint8 gray images.

    Returns a uint8 ``(D, H, W)`` volume: ``|L(y,x) - R(y,x-d)|`` where
    ``x >= d``, else ``invalid_cost`` (the reference writes 255 for
    out-of-range samples, ``BlockMatching.cpp:208-212``).
    """
    li = left_gray.astype(jnp.int16)
    ri = _shifted_right(right_gray.astype(jnp.int16), num_disparities)
    diff = jnp.abs(li[None, :, :] - ri)
    x = jnp.arange(left_gray.shape[-1])
    d = jnp.arange(num_disparities)
    valid = (x[None, :] >= d[:, None])[:, None, :]  # (D, 1, W)
    return jnp.where(valid, diff, invalid_cost).astype(jnp.uint8)


def ad_cost_volume_offset(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    count: int,
    d_offset: jnp.ndarray,
    invalid_cost: int = 255,
) -> jnp.ndarray:
    """AD cost for disparities ``d_offset .. d_offset+count-1`` → (count, H, W).

    ``d_offset`` may be traced (it is the shard's disparity-range start in
    the disp-sharded distributed pipeline). uint8 output as in
    :func:`ad_cost_volume`.
    """
    w = left_gray.shape[-1]
    x = jnp.arange(w)
    d = d_offset + jnp.arange(count)
    src = jnp.clip(x[None, :] - d[:, None], 0, w - 1)  # (count, W)
    gathered = jnp.take(right_gray.astype(jnp.int16), src, axis=-1)
    ri = jnp.moveaxis(gathered, -2, 0)  # (count, H, W)
    diff = jnp.abs(left_gray.astype(jnp.int16)[None, :, :] - ri)
    valid = (x[None, :] >= d[:, None])[:, None, :]
    return jnp.where(valid, diff, invalid_cost).astype(jnp.uint8)


def color_gradient_cost_volume(
    left_bgr: jnp.ndarray,
    right_bgr: jnp.ndarray,
    num_disparities: int,
    consts: CostConstants = CostConstants(),
) -> jnp.ndarray:
    """Truncated color+gradient cost of two (H, W, 3) uint8 images → (D, H, W) f32.

    ``cost(d,y,x) = α·min(mean_c|ΔBGR|, τ_color) + (1-α)·min(|Δgrad|, τ_grad)``
    with the right image shifted by d using left-edge replication
    (``StereoHelper.cpp:102-126``). Gradients are the reference's offset
    x-gradients of the Rec.601 gray (``StereoHelper.cpp:39-73``).
    """
    gray_l = _rec601_gray(left_bgr)
    gray_r = _rec601_gray(right_bgr)
    grad_l = gradient_x(gray_l)  # (H, W) f32
    grad_r = gradient_x(gray_r)

    # Shift color channels: (H, W, 3) → channel-major (3, H, W) for the gather.
    r_cmajor = jnp.moveaxis(right_bgr.astype(jnp.int16), -1, 0)
    r_shift = _shifted_right(r_cmajor, num_disparities)  # (D, 3, H, W)
    l_cmajor = jnp.moveaxis(left_bgr.astype(jnp.int16), -1, 0)
    color_ad = jnp.abs(l_cmajor[None] - r_shift).astype(jnp.float32)
    cost_color = jnp.minimum(jnp.mean(color_ad, axis=1), consts.tau_color)

    grad_shift = _shifted_right(grad_r, num_disparities)  # (D, H, W)
    cost_grad = jnp.minimum(jnp.abs(grad_l[None] - grad_shift), consts.tau_gradient)

    alpha = consts.alpha
    return (alpha * cost_color + (1.0 - alpha) * cost_grad).astype(jnp.float32)


def _rec601_gray(img_bgr: jnp.ndarray) -> jnp.ndarray:
    from gpu_stereo_matching_tpu.ops.color import gray_rec601_bgr

    return gray_rec601_bgr(img_bgr)


def right_cost_from_left(cost_left: jnp.ndarray) -> jnp.ndarray:
    """Derive the right-view cost volume from the left one.

    ``right(d,y,x) = left(d,y,x+d)`` where ``x+d < W``; at the right edge the
    previous disparity plane is carried over (``StereoHelper.cpp:156-180``).
    Input/output layout (D, H, W).
    """
    num_d, _, w = cost_left.shape
    x = jnp.arange(w)

    def step(carry, plane_d):
        plane, d = plane_d
        idx = jnp.clip(x + d, 0, w - 1)
        shifted = jnp.take(plane, idx, axis=-1)
        valid = (x + d <= w - 1)[None, :]
        out = jnp.where(valid, shifted, carry)
        return out, out

    # d=0 is always fully valid, so the initial carry is never exposed.
    init = jnp.take(cost_left[0], jnp.clip(x, 0, w - 1), axis=-1)
    _, planes = jax.lax.scan(step, init, (cost_left, jnp.arange(num_d)))
    return planes
