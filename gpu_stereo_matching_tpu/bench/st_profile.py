"""Stage breakdown of the batched ST-1 streaming path on the live backend.

Separates the group pipeline's costs so optimization targets the real
bottleneck (the reference's per-stage-timer pattern, ``Device.cu:204-292``):

* host build:   weights -> FH tree -> stride-bucket plan, per frame (C++)
* plan upload:  stacked plan arrays host->device, fenced
* image upload: stacked frame pairs host->device, fenced
* device:       the fused group dispatch, fenced by ``block_until_ready``
* fetch:        full disparity group device->host

Run: ``python -m gpu_stereo_matching_tpu.bench.st_profile``.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _fence(x):
    """Wait until ``x`` is computed on the device."""
    import jax

    return jax.block_until_ready(x)


def run_profile(
    root: str = "/root/reference/Images",
    scene_name: str = "Art",
    group_size: int = 8,
    reps: int = 3,
) -> dict:
    import jax
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.middlebury import load_middlebury_scene
    from gpu_stereo_matching_tpu.models.segment_tree import (
        _st1_device_group_jit,
        _st1_device_jit,
    )
    from gpu_stereo_matching_tpu.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
    )
    from gpu_stereo_matching_tpu.tree.stride import StridePlan, stack_stride_plans
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    cfg = SegmentTreeConfig()
    scene = load_middlebury_scene(root, scene_name)
    left = np.asarray(scene.left_bgr if hasattr(scene, "left_bgr") else scene.left)
    right = np.asarray(
        scene.right_bgr if hasattr(scene, "right_bgr") else scene.right
    )
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    frames = [(jitter(left), jitter(right)) for _ in range(group_size)]
    pipe = SegmentTreeBatchPipeline(cfg, group_size=group_size)

    out = {}

    # Host build, per frame (after one warm call so the layout registry is
    # converged and the C++ lib is loaded).
    pipe._build_plan(frames[0][0])
    t0 = time.perf_counter()
    plans = [pipe._build_plan(f[0]) for f in frames]
    out["host_build_ms_per_frame"] = (
        (time.perf_counter() - t0) / group_size * 1e3
    )
    for _ in range(4):  # converge layouts
        if len({p.layout_key for p in plans}) == 1:
            break
        plans = [pipe._build_plan(f[0]) for f in frames]
    stacked = stack_stride_plans(plans)
    out["plan_ints_mb"] = stacked.ints.nbytes / 1e6
    out["plan_codes_mb"] = stacked.codes.nbytes / 1e6
    out["plan_res_mb"] = (
        0.0 if stacked.res is None else stacked.res.nbytes / 1e6
    )
    out["plan_flg_mb"] = (
        0.0 if stacked.flg is None else stacked.flg.nbytes / 1e6
    )
    out["plan_total_mb_per_frame"] = stacked.transport_nbytes / group_size / 1e6

    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    out["images_mb"] = lefts.nbytes * 2 / 1e6

    def dev_plan():
        return stacked.to_device()

    # Uploads, fenced.
    p = dev_plan()
    _fence(p.ints)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        p = dev_plan()
        _fence(p.ints[0, :1])
        best = min(best, time.perf_counter() - t0)
    out["plan_upload_ms"] = best * 1e3

    jl = jax.device_put(lefts)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jl = jax.device_put(lefts)
        jr = jax.device_put(rights)
        _fence(jl[0, :1, :1])
        best = min(best, time.perf_counter() - t0)
    out["image_upload_ms"] = best * 1e3

    # Device compute: group dispatch on pre-uploaded data.
    jl, jr = jax.device_put(lefts), jax.device_put(rights)
    res = _st1_device_group_jit(jl, jr, p, cfg.max_disp_levels)
    _fence(res)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = _st1_device_group_jit(jl, jr, p, cfg.max_disp_levels)
        _fence(res)
        best = min(best, time.perf_counter() - t0)
    out["device_group_ms"] = best * 1e3
    out["device_ms_per_frame"] = best * 1e3 / group_size

    # Single-frame dispatch for comparison.
    p1 = stacked.frame(0).to_device()
    r1 = _st1_device_jit(jl[0], jr[0], p1, cfg.max_disp_levels)
    _fence(r1)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r1 = _st1_device_jit(jl[0], jr[0], p1, cfg.max_disp_levels)
        _fence(r1)
        best = min(best, time.perf_counter() - t0)
    out["device_single_ms"] = best * 1e3

    # Result fetch.
    res = _st1_device_group_jit(jl, jr, p, cfg.max_disp_levels)
    _fence(res)
    t0 = time.perf_counter()
    np.asarray(res)
    out["fetch_ms"] = (time.perf_counter() - t0) * 1e3

    print(json.dumps({k: round(v, 2) for k, v in out.items()}))
    return out


if __name__ == "__main__":
    run_profile()
