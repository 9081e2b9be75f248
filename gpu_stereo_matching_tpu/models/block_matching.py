"""SAD block-matching pipeline (the reference's ``BlockMatching`` project).

End-to-end: gray pair → per-disparity AD cost volume → (2r+1)² box-filter
SAD aggregation → WTA disparity, with optional LR consistency + median
post-filtering. The reference's live path is ``blockMatching_gpu``
(``BlockMatching/Device.cu:173-301``) driving ``kernalPreCal_V2`` and the
fused ``kernalFindCorr``; here :func:`block_matching_pipeline` is one jitted
XLA program (box sums via prefix scans instead of O(w²) window loops) and
the plain reference for the fused kernel in
:mod:`gpu_stereo_matching_tpu.kernels.sad_wta`, which
:func:`sad_wta_disparity` runs on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.core.validation import check_gray_pair
from gpu_stereo_matching_tpu.kernels.sad_wta import (
    INVALID_COST,
    fused_block_matching,
    fused_block_matching_key,
)
from gpu_stereo_matching_tpu.ops.aggregate import aggregate_cost_volume
from gpu_stereo_matching_tpu.ops.cost import ad_cost_volume, ad_cost_volume_offset
from gpu_stereo_matching_tpu.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu.ops.wta import wta_disparity


def _right_view_sad(sad: jnp.ndarray) -> jnp.ndarray:
    """Derive the right-view aggregated SAD from the left one.

    ``right(d,y,x) = left(d,y,x+d)`` (each left SAD entry compares
    L(x) ↔ R(x-d), which from the right view is R(x') ↔ L(x'+d));
    out-of-range samples get a +∞-like fill so WTA never picks them.
    """
    num_d, _, w = sad.shape
    x = jnp.arange(w)
    d = jnp.arange(num_d)
    src = x[None, :] + d[:, None]  # (D, W)
    valid = src <= w - 1
    gathered = _gather_wx(sad, jnp.clip(src, 0, w - 1))
    big = jnp.iinfo(jnp.int32).max if jnp.issubdtype(sad.dtype, jnp.integer) else jnp.inf
    return jnp.where(valid[:, None, :], gathered, big)


def _gather_wx(vol: jnp.ndarray, src: jnp.ndarray) -> jnp.ndarray:
    """Gather ``vol[d, y, src[d, x]]`` → (D, H, W)."""
    idx = jnp.broadcast_to(src[:, None, :], vol.shape)
    return jnp.take_along_axis(vol, idx, axis=-1)


def block_matching_disparity(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> jnp.ndarray:
    """Disparity of a (H, W) uint8 gray pair → (H, W) int32.

    Pure function of its inputs; safe to ``jax.jit`` / ``vmap`` over a batch.
    """
    cost = ad_cost_volume(
        left_gray, right_gray, config.num_disparities, int(config.invalid_cost)
    )
    sad = aggregate_cost_volume(cost, config.sad_radius)  # int32 (D, H, W)
    disp = wta_disparity(sad)

    if config.lr_consistency:
        sad_r = _right_view_sad(sad)
        disp_r = wta_disparity(sad_r)
        mask = lr_consistency_mask(disp, disp_r, config.lr_max_diff)
        disp = jnp.where(mask, disp, 0)

    if config.median_radius > 0:
        disp = median_filter_u8(disp.astype(jnp.uint8), config.median_radius).astype(
            jnp.int32
        )
    return disp


def sad_wta_disparity(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    num_disparities: int,
    radius: int,
) -> jnp.ndarray:
    """SAD + WTA disparity of (H, W) or (B, H, W) uint8 pairs → int32.

    Lowers to the fused kernel where the computation runs on a CUDA device
    and to the XLA ops path everywhere else; the two are bit-identical.
    The choice follows the platform each lowering targets, so one jitted
    caller can run on the GPU and on the host CPU in the same process.
    """
    config = BlockMatchingConfig(num_disparities=num_disparities, sad_radius=radius)

    def xla(left, right):
        if left.ndim == 3:
            return jax.vmap(lambda l, r: block_matching_disparity(l, r, config))(
                left, right
            )
        return block_matching_disparity(left, right, config)

    def kernel(left, right):
        return fused_block_matching(left, right, num_disparities, radius)

    return jax.lax.platform_dependent(
        left_gray, right_gray, cuda=kernel, default=xla
    )


def sad_wta_keys(
    left: jnp.ndarray,
    right: jnp.ndarray,
    d0,
    count: int,
    total: int,
    radius: int,
    invalid_cost: int = INVALID_COST,
    interpret: bool = False,
) -> jnp.ndarray:
    """Packed WTA keys ``min_d SAD·total + d`` over ``d0 .. d0+count-1`` for
    (B, H, W) uint8 slabs → (B, H, W) int32; ``d0`` may be traced.

    Like :func:`sad_wta_disparity`, the fused kernel where the computation
    runs on a CUDA device and the XLA ops path elsewhere (and always for an
    ``invalid_cost`` the kernel does not use); ``interpret`` runs the kernel
    in the Pallas interpreter instead.
    """

    def kernel(lf, rf, d0):
        return fused_block_matching_key(
            lf, rf, d0, count, total, radius, interpret=interpret
        )

    def xla(lf, rf, d0):
        def per_frame(lf, rf):
            vol = ad_cost_volume_offset(lf, rf, count, d0, invalid_cost)
            sad = aggregate_cost_volume(vol, radius)  # (count, H, W) int32
            d_ids = d0 + jnp.arange(count, dtype=jnp.int32)
            return jnp.min(sad * total + d_ids[:, None, None], axis=0)

        return jax.vmap(per_frame)(lf, rf)

    if interpret:
        return kernel(left, right, d0)
    if invalid_cost != INVALID_COST:
        return xla(left, right, d0)
    return jax.lax.platform_dependent(left, right, d0, cuda=kernel, default=xla)


def block_matching_frame(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> jnp.ndarray:
    """Like :func:`block_matching_disparity`, through the fused kernel on
    the GPU when the config allows it (no LR check, which needs the whole
    SAD volume); the median filter runs after it as usual."""
    if config.lr_consistency or int(config.invalid_cost) != INVALID_COST:
        return block_matching_disparity(left_gray, right_gray, config)
    disp = sad_wta_disparity(
        left_gray, right_gray, config.num_disparities, config.sad_radius
    )
    if config.median_radius > 0:
        disp = median_filter_u8(disp.astype(jnp.uint8), config.median_radius).astype(
            jnp.int32
        )
    return disp


@functools.partial(jax.jit, static_argnames=("config",))
def block_matching_pipeline(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    config: BlockMatchingConfig = BlockMatchingConfig(),
) -> jnp.ndarray:
    """Jitted single-pair (H, W) or batched (B, H, W) block matching."""
    check_gray_pair(left_gray, right_gray, config.num_disparities, "block_matching")
    if left_gray.ndim == 3:
        return jax.vmap(lambda l, r: block_matching_disparity(l, r, config))(
            left_gray, right_gray
        )
    return block_matching_disparity(left_gray, right_gray, config)
