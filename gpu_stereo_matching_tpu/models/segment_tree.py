"""Non-local segment-tree stereo pipelines ST-1 / ST-2.

Mirrors the reference drivers ``stereo_disparity_normal`` and
``stereo_disparity_iteration`` (``STMatching/StereoDisparity.cpp:57-162``):

ST-1: color+gradient cost volume → segment tree (color weights, σ, τ=1200)
→ non-local filter → WTA → 7×7 median → ×scale.

ST-2: left volume + right volume derived from it → per-view trees with
σ₁=0.08 → filter/WTA/median per view → left-right consistency mask on the
*median-filtered* maps → fresh cost volume → tree rebuilt with joint
color+depth weights (stable pixels only) at the user σ → filter → WTA →
median → ×scale.

Orchestration is host-driven because the tree build is host-side C++;
every dense stage (cost, filter scans, WTA, median) is a jitted device
computation. Trees are data-dependent, so pipelines that process video with
a fixed calibration should reuse plans via the functions' ``plan`` hooks.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu.core.validation import check_bgr_pair
from gpu_stereo_matching_tpu.ops.cost import (
    color_gradient_cost_volume,
    right_cost_from_left,
)
from gpu_stereo_matching_tpu.ops.postprocess import lr_consistency_mask, median_filter_u8
from gpu_stereo_matching_tpu.ops.wta import wta_disparity
from gpu_stereo_matching_tpu.tree.builder import (
    build_segment_tree,
    color_depth_edge_weights,
    color_edge_weights,
)
from gpu_stereo_matching_tpu.tree.filter import tree_filter_nodes
from gpu_stereo_matching_tpu.tree.hpd import (
    CodedPlan,
    HeavyPathPlan,
    PlanOrderPlan,
    tree_filter_nodes_hpd,
    tree_filter_nodes_po,
    tree_filter_nodes_po_coded,
)
from gpu_stereo_matching_tpu.tree.stride import (
    StridePlan,
    converged_stride_batch,
    tree_filter_nodes_sb,
)


_cost_volume_jit = jax.jit(color_gradient_cost_volume, static_argnums=(2,))


def _filter_wta_median(cost_nodes, plan, shape_hw):
    # cost_nodes: (N, D); returns median-filtered uint8 disparity (H, W).
    h, w = shape_hw
    if isinstance(plan, StridePlan):
        filtered = tree_filter_nodes_sb(cost_nodes, plan)
    elif isinstance(plan, CodedPlan):
        # reduce="argmin" (WTA before the inverse permutation, one int32
        # per node instead of D floats through the final gather) is the
        # alternative; which is faster on the GPU is not measured yet.
        filtered = tree_filter_nodes_po_coded(cost_nodes, plan)
    elif isinstance(plan, PlanOrderPlan):
        filtered = tree_filter_nodes_po(cost_nodes, plan)
    elif isinstance(plan, HeavyPathPlan):
        filtered = tree_filter_nodes_hpd(cost_nodes, plan)
    else:
        filtered = tree_filter_nodes(cost_nodes, plan)
    disp = wta_disparity(filtered, axis=1).reshape(h, w)
    return median_filter_u8(disp.astype(jnp.uint8), 3)


_filter_wta_median_jit = jax.jit(_filter_wta_median, static_argnums=(2,))


def _st1_device(left_bgr, right_bgr, plan, num_disp):
    # Single dispatch: cost volume → tree filter → WTA → median.
    cost = color_gradient_cost_volume(left_bgr, right_bgr, num_disp)
    d, h, w = cost.shape
    return _filter_wta_median(_to_nodes(cost), plan, (h, w))


_st1_device_jit = jax.jit(_st1_device, static_argnums=(3,))


def _st1_device_batched(left_b, right_b, plans, num_disp):
    """One dispatch for a whole frame group: (B,H,W,3)×2 + stacked plans.

    Requires the scatter-free plan-order filter (``PlanOrderPlan``) — the
    scatter-based formulations batch catastrophically under vmap (round-1
    negative result, ROADMAP.md).
    """

    def one(left, right, plan):
        cost = color_gradient_cost_volume(left, right, num_disp)
        d, h, w = cost.shape
        return _filter_wta_median(_to_nodes(cost), plan, (h, w))

    return jax.vmap(one)(left_b, right_b, plans)


_st1_device_batched_jit = jax.jit(_st1_device_batched, static_argnums=(3,))


def _frame_plan(plans, g):
    """Frame ``g``'s view of a stacked plan (``g`` may be traced)."""
    if isinstance(plans, StridePlan):
        return plans.frame(g)
    if isinstance(plans, CodedPlan):
        return CodedPlan(
            plans.num_nodes, plans.total_pos, plans.rounds_meta,
            plans.ints[g], plans.codes[g], plans.table,
            plans.scan_steps, plans.n_real,
        )
    return PlanOrderPlan(
        plans.num_nodes, plans.total_pos, plans.rounds_meta,
        plans.ints[g], plans.floats[g],
    )


def _st1_device_group(left_b, right_b, plans, num_disp):
    """One dispatch for a frame group: a device loop (``lax.map``) of the
    single-frame program over stacked plans.

    The loop body is the single-frame program, so a group compiles once
    per plan layout whatever its size; an unrolled loop makes G copies of
    a large program, which the GPU compiler takes tens of minutes over at
    G=8. vmapping the filter instead would batch its gathers.
    """

    def one(g):
        cost = color_gradient_cost_volume(left_b[g], right_b[g], num_disp)
        d, h, w = cost.shape
        return _filter_wta_median(_to_nodes(cost), _frame_plan(plans, g), (h, w))

    return jax.lax.map(one, jnp.arange(left_b.shape[0]))


_st1_device_group_jit = jax.jit(_st1_device_group, static_argnums=(3,))


def _st1_device_merged(left_b, right_b, merged_plan, num_disp):
    """One dispatch for a frame group via a merged forest plan.

    The streaming pipeline uses the per-frame group dispatch instead (see
    ``tree.hpd.merge_plans`` for the merged layout). Kept for workloads
    that want one logical filter over a forest.
    """
    from gpu_stereo_matching_tpu.tree.hpd import tree_filter_nodes_po_merged

    cn = jax.vmap(
        lambda l, r: _to_nodes(color_gradient_cost_volume(l, r, num_disp))
    )(left_b, right_b)
    filtered = tree_filter_nodes_po_merged(cn, merged_plan)
    h, w = left_b.shape[1:3]

    def post(f):
        disp = wta_disparity(f, axis=1).reshape(h, w)
        return median_filter_u8(disp.astype(jnp.uint8), 3)

    return jax.vmap(post)(filtered)


_st1_device_merged_jit = jax.jit(_st1_device_merged, static_argnums=(3,))


def _st1_device_group_banded(left_b, right_b, plans, num_disp, num_bands):
    """One dispatch for a frame group with PER-BAND trees.

    ``plans`` is a (G·B)-stacked :class:`StridePlan` — frame g's band t at
    index g·B+t. Per frame: ONE full-frame cost volume (the cost has no
    vertical taps, so band slices are bit-identical to per-band costs —
    see parallel/segment_tree.py), then each band runs
    filter → WTA → 7×7 median on its own tree; bands concatenate back to
    the full frame. Bit-identical to
    ``models.segment_tree_tiled.st1_disparity_tiled`` with equal bands.

    Why: at HD the single global tree's host build+emit outweighs the
    device work and adds super-linear light-depth rounds at N≈1M. B independent band
    trees parallelize the host build across threads AND cut each tree's
    round count; the ≤0.42pp bad-2.0 cost is quantified in RESULTS.md.
    """

    def one(g):
        cost = color_gradient_cost_volume(left_b[g], right_b[g], num_disp)
        d, h, w = cost.shape
        hb = h // num_bands
        bands = []
        for t in range(num_bands):
            cost_band = jax.lax.slice_in_dim(
                cost, t * hb, (t + 1) * hb, axis=1
            )
            bands.append(
                _filter_wta_median(
                    _to_nodes(cost_band), plans.frame(g * num_bands + t),
                    (hb, w),
                )
            )
        return jnp.concatenate(bands, axis=0)

    return jax.lax.map(one, jnp.arange(left_b.shape[0]))


_st1_device_group_banded_jit = jax.jit(
    _st1_device_group_banded, static_argnums=(3, 4)
)


def _st2_phase1_group(left_b, right_b, plans_lr, num_disp, lr_max_diff):
    """ST-2 phase 1 for a whole frame group in ONE dispatch.

    Per frame: cost_left → derived cost_right
    (``StereoHelper.cpp:156-180``), both views filtered through their σ₁
    trees, WTA, 7×7 median, then the left-right stability mask
    (``StereoDisparity.cpp:107-147``). ``plans_lr`` is a 2B-stacked
    :class:`StridePlan` — frame g's LEFT tree at index g, its RIGHT tree
    at index B+g — so the whole group ships one plan upload per σ₁ table.
    Returns ONE (B, H, W) u8 array packing both host inputs of the
    color+depth re-segmentation: bits 0-6 the median-filtered left
    disparity (< 128 always — unscaled levels), bit 7 the LR-stability
    mask — halving the mid-group fetch, which is a hard sync point of
    the ST-2 pipeline (unpack with :func:`_unpack_phase1`).
    """
    if num_disp > 128:
        raise ValueError("phase-1 packing needs num_disp <= 128 (7 bits)")
    b = left_b.shape[0]

    def one(g):
        cost_l = color_gradient_cost_volume(left_b[g], right_b[g], num_disp)
        cost_r = right_cost_from_left(cost_l)
        d, h, w = cost_l.shape
        disp_l = _filter_wta_median(
            _to_nodes(cost_l), plans_lr.frame(g), (h, w)
        )
        disp_r = _filter_wta_median(
            _to_nodes(cost_r), plans_lr.frame(b + g), (h, w)
        )
        mask = lr_consistency_mask(
            disp_l.astype(jnp.int32), disp_r.astype(jnp.int32), lr_max_diff
        )
        return disp_l | jnp.where(mask, jnp.uint8(128), jnp.uint8(0))

    return jax.lax.map(one, jnp.arange(b))


_st2_phase1_group_jit = jax.jit(_st2_phase1_group, static_argnums=(3, 4))


def _unpack_phase1(packed: np.ndarray):
    """Host side: (…, H, W) u8 → (disp_left u8 bits 0-6, mask bool bit 7)."""
    p = np.asarray(packed)
    return (p & 0x7F).astype(np.uint8), (p & 0x80) != 0


def _sigma1_tree(img_bgr: np.ndarray, config: SegmentTreeConfig):
    h, w = img_bgr.shape[:2]
    return build_segment_tree(
        color_edge_weights(img_bgr), h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=1.0,
    )


def _final_tree(
    left_bgr: np.ndarray, disp_l: np.ndarray, mask: np.ndarray,
    config: SegmentTreeConfig,
):
    h, w = left_bgr.shape[:2]
    weights = color_depth_edge_weights(
        left_bgr, disp_l, mask, config.max_disp_levels, config.alpha_dep_seg
    )
    return build_segment_tree(
        weights, h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=255.0,
    )


def _to_nodes(cost: jnp.ndarray) -> jnp.ndarray:
    d, h, w = cost.shape
    return jnp.moveaxis(cost, 0, -1).reshape(h * w, d)


def _aggregate_select(
    cost: jnp.ndarray, img_bgr: np.ndarray, sigma: float, cfg: SegmentTreeConfig,
    weights: Optional[np.ndarray] = None,
    weight_scale: float = 1.0,
) -> np.ndarray:
    """Tree build (host) + filter/WTA/median (device) → uint8 (H, W)."""
    d, h, w = cost.shape
    if weights is None:
        weights = color_edge_weights(img_bgr)
        weight_scale = 1.0
    tree = build_segment_tree(
        weights, h, w,
        tau=cfg.tau, min_size=cfg.min_size_seg, penalty=cfg.penalty_cross_seg,
        weight_scale=weight_scale,
    )
    # Stride-bucket heavy-path plan: O(log²N)-depth per-bucket scans with
    # static head slices and in-graph light addressing — the fastest and
    # smallest-transport formulation (see tree/stride.py; the coded
    # plan-order path remains as an oracle).
    plan = StridePlan.from_tree(tree, sigma)
    return np.asarray(_filter_wta_median_jit(_to_nodes(cost), plan, (h, w)))


def st1_disparity(
    left_bgr: np.ndarray,
    right_bgr: np.ndarray,
    config: SegmentTreeConfig = SegmentTreeConfig(),
) -> np.ndarray:
    """ST-1 scaled disparity of a BGR uint8 pair → (H, W) uint8.

    One host round trip (edge weights for the tree build) plus one fused
    device dispatch (cost → heavy-path filter → WTA → median).
    """
    check_bgr_pair(left_bgr, right_bgr, config.max_disp_levels, "st1")
    h, w = left_bgr.shape[:2]
    weights = color_edge_weights(left_bgr)
    tree = build_segment_tree(
        weights, h, w,
        tau=config.tau, min_size=config.min_size_seg,
        penalty=config.penalty_cross_seg, weight_scale=1.0,
    )
    plan = StridePlan.from_tree(tree, config.sigma)
    disp = np.asarray(
        _st1_device_jit(
            jnp.asarray(left_bgr), jnp.asarray(right_bgr), plan,
            config.max_disp_levels,
        )
    )
    return _scale_u8(disp, config.disparity_scale)


def st2_disparity(
    left_bgr: np.ndarray,
    right_bgr: np.ndarray,
    config: SegmentTreeConfig = SegmentTreeConfig(),
) -> np.ndarray:
    """ST-2 (iteration + LR consistency + re-segmentation) → (H, W) uint8.

    Two fused device dispatches with one host tree rebuild between them
    (the minimum the data dependency allows — the color+depth weights
    need phase 1's disparity/mask on the host,
    ``StereoDisparity.cpp:91-159``): phase 1 computes both σ₁ view
    filters + WTA + median + the LR mask in one program; phase 2 is the
    ST-1 program over the rebuilt tree. Round 5: this is the B=1 case of
    the group path the streaming pipeline batches
    (:class:`models.segment_tree_stream.SegmentTreeST2BatchPipeline`).
    """
    check_bgr_pair(left_bgr, right_bgr, config.max_disp_levels, "st2")
    plans1 = converged_stride_batch(
        [_sigma1_tree(left_bgr, config), _sigma1_tree(right_bgr, config)],
        config.sigma_one,
    ).to_device()
    jl = jnp.asarray(left_bgr)[None]
    jr = jnp.asarray(right_bgr)[None]
    packed = _st2_phase1_group_jit(
        jl, jr, plans1, config.max_disp_levels, config.lr_max_diff
    )
    disp_l_b, mask_b = _unpack_phase1(packed)
    disp_l, mask = disp_l_b[0], mask_b[0]

    plan2 = converged_stride_batch(
        [_final_tree(left_bgr, disp_l, mask, config)], config.sigma
    ).to_device()
    disp = np.asarray(
        _st1_device_group_jit(jl, jr, plan2, config.max_disp_levels)
    )[0]
    return _scale_u8(disp, config.disparity_scale)


def segment_tree_disparity(
    left_bgr: np.ndarray,
    right_bgr: np.ndarray,
    config: SegmentTreeConfig = SegmentTreeConfig(),
) -> np.ndarray:
    """Dispatch ST-1 / ST-2 on ``config.iterate`` (the CLI ``method`` arg)."""
    fn = st2_disparity if config.iterate else st1_disparity
    return fn(left_bgr, right_bgr, config)


def _scale_u8(disp: np.ndarray, scale: int) -> np.ndarray:
    return np.minimum(disp.astype(np.int32) * scale, 255).astype(np.uint8)
