"""BASELINE config-3 scale: segment-tree path at 128 disparities.

Two datapoints the correctness gates don't cover:

* the ST-1 device rate at 128 disparity levels (the config-3
  shape; correctness is gated by
  ``tests/test_segment_tree_pipeline.py`` fidelity tests), measured as
  a 4-frame group dispatch ended by ``block_until_ready``, and
* the per-band sharded-ST-1 step at a realistic band height (what one
  device of an 8-band ``space`` deployment executes per frame): the same
  program `parallel.segment_tree` runs per shard, on a half-image band.

Run: ``python -m gpu_stereo_matching_tpu.bench.st_config3``.
"""

from __future__ import annotations

import json
import time

import numpy as np


def _fence(x):
    """Wait until ``x`` is computed on the device."""
    import jax

    return jax.block_until_ready(x)


def _best(f, reps=3):
    f()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best = min(best, time.perf_counter() - t0)
    return best


def run_config3(
    root: str = "/root/reference/Images",
    scene_name: str = "Art",
    num_disp: int = 128,
    group: int = 4,
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
    from gpu_stereo_matching_tpu.tree.stride import stack_stride_plans
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    cfg = SegmentTreeConfig(max_disp_levels=num_disp)
    scene = load_middlebury_scene(root, scene_name)
    left = np.asarray(
        scene.left_bgr if hasattr(scene, "left_bgr") else scene.left
    )
    right = np.asarray(
        scene.right_bgr if hasattr(scene, "right_bgr") else scene.right
    )
    h, w = left.shape[:2]
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    frames = [(jitter(left), jitter(right)) for _ in range(group)]
    pipe = SegmentTreeBatchPipeline(cfg, group_size=group)
    plans = [pipe._build_plan(f[0]) for f in frames]
    for _ in range(4):
        if len({p.layout_key for p in plans}) == 1:
            break
        plans = [pipe._build_plan(f[0]) for f in frames]
    stacked = jax.device_put(stack_stride_plans(plans))
    jl = jax.device_put(np.stack([f[0] for f in frames]))
    jr = jax.device_put(np.stack([f[1] for f in frames]))

    best = _best(
        lambda: _fence(
            _st1_device_group_jit(jl, jr, stacked, num_disp)
        )
    )
    out = {
        "metric": f"st1_device_{h}x{w}_{num_disp}disp_fps",
        "value": group / best,
        "unit": "frames/sec",
        "ms_per_frame": best / group * 1e3,
    }
    print(json.dumps(out))

    # Per-band step: one space-shard's frame work in an 8-band deployment
    # (band height ~ H/2 of this scene stands in for 1/8 of a full-res
    # capture). Single-frame dispatch, fenced by ``block_until_ready``.
    hb = (h // 2) // 8 * 8
    band_l, band_r = left[:hb], right[:hb]
    pipe_b = SegmentTreeBatchPipeline(cfg, group_size=1)
    plan_b = pipe_b._build_plan(band_l)
    plan_b = jax.device_put(stack_stride_plans([plan_b]))
    plan_b1 = plan_b.frame(0)
    bl, br = jax.device_put(band_l), jax.device_put(band_r)
    best_b = _best(
        lambda: _fence(_st1_device_jit(bl, br, plan_b1, num_disp))
    )
    out_b = {
        "metric": f"st1_band_step_{hb}x{w}_{num_disp}disp_ms",
        "value": best_b * 1e3,
        "unit": "ms/frame/shard (single dispatch)",
    }
    print(json.dumps(out_b))
    return {"full": out, "band": out_b}


if __name__ == "__main__":
    run_config3()
