"""Pipelined segment-tree video processing.

Per-frame ST-1 has a host stage (C++ weights/median → FH spanning tree →
HPD plan, ~65 ms at Middlebury size since the native providers and plan
core landed) and a device stage (cost → tree filter → WTA → median, one
fused dispatch). Sequentially they serialize; this pipeline overlaps
them — the software-pipelining analog of the reference's absent streaming
mode (SURVEY §2.5 "PP analog"):

    stage A (host):          build weights + tree + plan for frame i+1
    stage B (device, async): fused disparity dispatch for frame i
    stage C (host):          fetch disparity i-1

JAX's async dispatch provides the concurrency — the host builds frame
i+1's tree while the device crunches frame i, because frame i's dispatch
was queued before the build starts.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
from gpu_stereo_matching_tpu.models.segment_tree import (
    _final_tree,
    _scale_u8,
    _sigma1_tree,
    _st1_device_group_banded_jit,
    _st1_device_group_jit,
    _st1_device_jit,
    _st2_phase1_group_jit,
    _unpack_phase1,
)
from gpu_stereo_matching_tpu.tree.builder import build_segment_tree, color_edge_weights
from gpu_stereo_matching_tpu.tree.stride import StridePlan, stack_stride_plans


class SegmentTreeVideoPipeline:
    """Streaming ST-1 over an iterator of (left_bgr, right_bgr) frames."""

    def __init__(self, config: SegmentTreeConfig = SegmentTreeConfig()) -> None:
        self.config = config

    def _host_build(self, left_bgr: np.ndarray) -> StridePlan:
        cfg = self.config
        h, w = left_bgr.shape[:2]
        weights = color_edge_weights(left_bgr)
        tree = build_segment_tree(
            weights, h, w,
            tau=cfg.tau, min_size=cfg.min_size_seg,
            penalty=cfg.penalty_cross_seg, weight_scale=1.0,
        )
        return StridePlan.from_tree(tree, cfg.sigma)

    def process(
        self, frames: Iterable[Tuple[np.ndarray, np.ndarray]]
    ) -> Iterator[np.ndarray]:
        """Yield scaled uint8 disparity maps, one per input frame pair."""
        cfg = self.config
        pending: Optional[jnp.ndarray] = None  # device result for frame i-1

        it = iter(frames)
        try:
            cur = next(it)
        except StopIteration:
            return
        cur_plan = self._host_build(cur[0])

        while cur is not None:
            nxt = next(it, None)
            # Queue the big dispatch for the current frame (async).
            out = _st1_device_jit(
                jnp.asarray(cur[0]), jnp.asarray(cur[1]), cur_plan,
                cfg.max_disp_levels,
            )
            # While the device runs, do the next frame's host-side build.
            nxt_plan = self._host_build(nxt[0]) if nxt is not None else None
            # Drain the previous frame's result.
            if pending is not None:
                yield _scale_u8(np.asarray(pending), cfg.disparity_scale)
            pending = out
            cur, cur_plan = nxt, nxt_plan

        if pending is not None:
            yield _scale_u8(np.asarray(pending), cfg.disparity_scale)


class SegmentTreeBatchPipeline:
    """Batched streaming ST-1: G frames per device dispatch.

    Per-frame ST dispatches pay a fixed per-dispatch cost that caps
    throughput regardless of kernel speed; batching G frames into one
    dispatch amortizes it.  Host tree builds (C++ via ctypes —
    the GIL is released during the calls) run on a small thread pool and
    are overlapped with the device dispatch of the previous group, same
    software-pipelining scheme as :class:`SegmentTreeVideoPipeline`.

    Output order and values match the per-frame pipeline (the plan-order
    filter is bit-identical single vs batched).
    """

    def __init__(
        self,
        config: SegmentTreeConfig = SegmentTreeConfig(),
        group_size: int = 8,
        workers: int = 2,
        bands: int = 1,
    ) -> None:
        """``bands > 1`` builds B independent per-band trees per frame
        (the HD host-solvency lever): the C++ build/emit
        parallelizes across the pool AND each tree's light-depth round
        count drops. Output matches ``st1_disparity_tiled(…, bands)``
        bitwise; accuracy cost vs the global tree is quantified in
        RESULTS.md (≤0.42pp bad-2.0 at 8 bands)."""
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        if bands < 1:
            raise ValueError("bands must be >= 1")
        self.config = config
        self.group_size = group_size
        self.workers = workers
        self.bands = bands

    def _build_plan(self, left_bgr: np.ndarray) -> StridePlan:
        cfg = self.config
        h, w = left_bgr.shape[:2]
        weights = color_edge_weights(left_bgr)
        tree = build_segment_tree(
            weights, h, w,
            tau=cfg.tau, min_size=cfg.min_size_seg,
            penalty=cfg.penalty_cross_seg, weight_scale=1.0,
        )
        # Host-side arrays: the group ships as ONE stacked plan upload.
        return StridePlan.from_tree(tree, cfg.sigma, device=False)

    def _band_images(self, padded):
        """Per-band left crops, frame-major: frame g band t at g·B+t."""
        b = self.bands
        out = []
        for f in padded:
            h = f[0].shape[0]
            if h % b:
                raise ValueError(f"H={h} must divide into {b} equal bands")
            hb = h // b
            out += [f[0][t * hb : (t + 1) * hb] for t in range(b)]
        return out

    def _host_build_group(self, group, pool) -> Tuple[np.ndarray, np.ndarray, StridePlan, int]:
        """Stack a (possibly short) group; pad by repeating the last frame."""
        n_real = len(group)
        g = self.group_size
        padded = list(group) + [group[-1]] * (g - n_real)
        lefts = np.stack([f[0] for f in padded])
        rights = np.stack([f[1] for f in padded])
        imgs = (
            [f[0] for f in padded] if self.bands == 1
            else self._band_images(padded)
        )
        plans = list(pool.map(self._build_plan, imgs))
        # Converge layouts to a fixed point (the registry is monotone, but
        # a build can grow it — see tree.hpd.converged_plan_batch).
        for _ in range(8):
            if len({p.layout_key for p in plans}) == 1:
                break
            plans = list(pool.map(self._build_plan, imgs))
        return lefts, rights, stack_stride_plans(plans), n_real

    def process(
        self, frames: Iterable[Tuple[np.ndarray, np.ndarray]]
    ) -> Iterator[np.ndarray]:
        """Yield scaled uint8 disparity maps, one per input frame pair."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.config
        g = self.group_size

        def chunks(it):
            buf = []
            for f in it:
                buf.append(f)
                if len(buf) == g:
                    yield buf
                    buf = []
            if buf:
                yield buf

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            it = chunks(iter(frames))
            cur = next(it, None)
            if cur is None:
                return
            cur_host = self._host_build_group(cur, pool)
            pending = None  # (device array, n_real) for group i-1

            while cur_host is not None:
                lefts, rights, plans, n_real = cur_host
                if self.bands == 1:
                    out = _st1_device_group_jit(
                        jnp.asarray(lefts), jnp.asarray(rights), plans,
                        cfg.max_disp_levels,
                    )
                else:
                    out = _st1_device_group_banded_jit(
                        jnp.asarray(lefts), jnp.asarray(rights), plans,
                        cfg.max_disp_levels, self.bands,
                    )
                # Overlap: next group's host build runs while the device
                # crunches the current group (async dispatch above).
                nxt = next(it, None)
                nxt_host = (
                    self._host_build_group(nxt, pool) if nxt is not None
                    else None
                )
                if pending is not None:
                    arr, k = pending
                    for row in np.asarray(arr)[:k]:
                        yield _scale_u8(row, cfg.disparity_scale)
                pending = (out, n_real)
                cur_host = nxt_host

            arr, k = pending
            for row in np.asarray(arr)[:k]:
                yield _scale_u8(row, cfg.disparity_scale)


class SegmentTreeST2BatchPipeline:
    """Batched streaming ST-2 (the refined iteration pipeline,
    ``STMatching/StereoDisparity.cpp:91-159``): G frames per device
    dispatch, TWO dispatches per group with one host tree-rebuild between
    them — the minimum the ST-2 data dependency allows (the color+depth
    re-segmentation weights need phase 1's disparity + LR mask on the
    host, where the C++ tree builder lives).

    Per group:

    * host σ₁ stage: build LEFT and RIGHT view trees for every frame
      (2G builds on the thread pool), stacked into ONE 2G plan — the two
      per-view plan uploads of the naive path collapse into one.
    * device phase 1 (one dispatch): per frame cost_left → derived
      cost_right → both view filters → WTA → median → LR mask.
    * host rebuild: color+depth weights → per-frame re-segmentation
      trees → stacked σ plan (pool-parallel).
    * device phase 2 (one dispatch): the ST-1 group program over the
      rebuilt trees (fresh cost → filter → WTA → median).

    Overlap: the NEXT group's σ₁ builds run while this group's phase-1
    dispatch is on the device, and the PREVIOUS group's phase-2 results
    are drained while this group's phase-2 dispatch runs — the same
    software-pipelining scheme as :class:`SegmentTreeBatchPipeline`.
    Output values are bit-identical to per-pair ``st2_disparity``.
    """

    def __init__(
        self,
        config: SegmentTreeConfig = SegmentTreeConfig(),
        group_size: int = 8,
        workers: int = 4,
        lean: bool = True,
    ) -> None:
        """``lean`` picks the plan transport format: True (default) ships
        the minimal payload and inverts the permutation in-graph on the
        device; False ships inv_perm verbatim (more bytes per plan, no
        in-graph inversion in any of the 3 filters per frame)."""
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        self.config = config
        self.group_size = group_size
        self.workers = workers
        self.lean = lean

    def _converge(self, pool, build_fns):
        """pool-map plan builders to one shared layout (registry-monotone)."""
        plans = list(pool.map(lambda f: f(), build_fns))
        for _ in range(8):
            if len({p.layout_key for p in plans}) == 1:
                break
            plans = list(pool.map(lambda f: f(), build_fns))
        return stack_stride_plans(plans)

    def _sigma1_group(self, group, pool):
        """Stack a (possibly short) group; build the 2G σ₁ plan."""
        cfg = self.config
        n_real = len(group)
        padded = list(group) + [group[-1]] * (self.group_size - n_real)
        lefts = np.stack([f[0] for f in padded])
        rights = np.stack([f[1] for f in padded])
        imgs = [f[0] for f in padded] + [f[1] for f in padded]
        plans = self._converge(
            pool,
            [
                (lambda im=im: StridePlan.from_tree(
                    _sigma1_tree(im, cfg), cfg.sigma_one, device=False,
                    lean=self.lean,
                ))
                for im in imgs
            ],
        )
        return lefts, rights, plans, n_real

    def _final_plans(self, lefts, disp_l_b, mask_b, pool):
        cfg = self.config
        return self._converge(
            pool,
            [
                (lambda i=i: StridePlan.from_tree(
                    _final_tree(lefts[i], disp_l_b[i], mask_b[i], cfg),
                    cfg.sigma, device=False, lean=self.lean,
                ))
                for i in range(len(lefts))
            ],
        )

    def process(
        self, frames: Iterable[Tuple[np.ndarray, np.ndarray]]
    ) -> Iterator[np.ndarray]:
        """Yield scaled uint8 ST-2 disparity maps, one per frame pair."""
        from concurrent.futures import ThreadPoolExecutor

        import jax.numpy as jnp

        cfg = self.config
        g = self.group_size

        def chunks(it):
            buf = []
            for f in it:
                buf.append(f)
                if len(buf) == g:
                    yield buf
                    buf = []
            if buf:
                yield buf

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            it = chunks(iter(frames))
            cur = next(it, None)
            if cur is None:
                return
            cur_h1 = self._sigma1_group(cur, pool)
            pending = None  # (phase-2 device array, n_real) for group i-1

            while cur_h1 is not None:
                lefts, rights, plans1, n_real = cur_h1
                jl, jr = jnp.asarray(lefts), jnp.asarray(rights)
                packed = _st2_phase1_group_jit(
                    jl, jr, plans1.to_device(), cfg.max_disp_levels,
                    cfg.lr_max_diff,
                )
                # Overlap: next group's σ₁ host builds run while phase 1
                # is on the device (async dispatch above).
                nxt = next(it, None)
                nxt_h1 = (
                    self._sigma1_group(nxt, pool) if nxt is not None
                    else None
                )
                # Phase-1 fetch (sync point — the host needs these; one
                # u8 image per frame, disparity + mask bit-packed).
                disp_l_np, mask_np = _unpack_phase1(packed)
                plans2 = self._final_plans(lefts, disp_l_np, mask_np, pool)
                out = _st1_device_group_jit(
                    jl, jr, plans2.to_device(), cfg.max_disp_levels
                )
                # Drain the previous group while phase 2 runs.
                if pending is not None:
                    arr, k = pending
                    for row in np.asarray(arr)[:k]:
                        yield _scale_u8(row, cfg.disparity_scale)
                pending = (out, n_real)
                cur_h1 = nxt_h1

            arr, k = pending
            for row in np.asarray(arr)[:k]:
                yield _scale_u8(row, cfg.disparity_scale)
