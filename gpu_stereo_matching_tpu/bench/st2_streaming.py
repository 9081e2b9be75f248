"""ST-2 (refined iteration) streaming-video throughput.

ST-2 is the reference's flagship result (``STMatching/StereoDisparity.cpp:
91-159``): per-view σ₁ trees, LR consistency, color+depth re-segmentation.
Structurally it costs three tree filters + two host tree-build stages per
frame (~3× ST-1), and the naive per-pair path additionally pays five
dispatch round trips and three separate plan uploads. This bench measures
the batched/streaming path (:class:`models.segment_tree_stream.
SegmentTreeST2BatchPipeline`) that amortizes all of that per group.

Reported numbers (same discipline as ``bench/st_streaming.py``):

* ``st2_device_fps`` — the two group dispatches (phase 1: 2 filters + LR;
  phase 2: rebuilt-tree filter) on resident data, ended by
  ``block_until_ready``, divided by group size: one device's sustained
  ST-2 rate.
* ``st2_streaming_e2e_fps`` — wall clock end to end, host stages included.

Run: ``python -m gpu_stereo_matching_tpu.bench.st2_streaming``
"""

from __future__ import annotations

import json
import time

import numpy as np


def run_st2_streaming_benchmark(
    root: str = "/root/reference/Images",
    scene_name: str = "Art",
    num_frames: int = 32,
    group_size: int = 8,
    workers: int = 4,
    device_rate_lean: bool = True,
) -> float:
    """``device_rate_lean=False`` measures the device rate with
    shipped-inv (device-resident) plans."""
    import jax

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.middlebury import load_middlebury_scene
    from gpu_stereo_matching_tpu.models.segment_tree import (
        _st1_device_group_jit,
        _st2_phase1_group_jit,
        _unpack_phase1,
    )
    from gpu_stereo_matching_tpu.models.segment_tree_stream import (
        SegmentTreeST2BatchPipeline,
    )
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    cfg = SegmentTreeConfig()
    scene = load_middlebury_scene(root, scene_name)
    left, right = scene.left_bgr, scene.right_bgr
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    frames = [(jitter(left), jitter(right)) for _ in range(num_frames)]
    pipe = SegmentTreeST2BatchPipeline(
        cfg, group_size=group_size, workers=workers
    )

    # Warm pass: converge plan layouts (σ₁ AND the data-dependent
    # color+depth layouts) + compile both group dispatches.
    for _ in pipe.process(frames):
        pass

    start = time.perf_counter()
    n_out = 0
    for _ in pipe.process(frames):
        n_out += 1
    e2e_fps = n_out / (time.perf_counter() - start)
    h, w = left.shape[:2]

    # Device rate: both group dispatches on resident data, with the host
    # rebuild excluded (it overlaps in the pipeline; here we
    # pre-build both plans to isolate chip time).
    from concurrent.futures import ThreadPoolExecutor

    group = frames[:group_size]
    dev_pipe = SegmentTreeST2BatchPipeline(
        cfg, group_size=group_size, workers=workers, lean=device_rate_lean
    )
    with ThreadPoolExecutor(max_workers=workers) as pool:
        lefts, rights, plans1, _n = dev_pipe._sigma1_group(group, pool)
        jl, jr = jax.device_put(lefts), jax.device_put(rights)
        p1 = plans1.to_device()
        packed = _st2_phase1_group_jit(
            jl, jr, p1, cfg.max_disp_levels, cfg.lr_max_diff
        )
        disp_l_b, mask_b = _unpack_phase1(packed)
        plans2 = dev_pipe._final_plans(lefts, disp_l_b, mask_b, pool)
        p2 = plans2.to_device()

    def dispatch():
        d = _st2_phase1_group_jit(
            jl, jr, p1, cfg.max_disp_levels, cfg.lr_max_diff
        )
        out = _st1_device_group_jit(jl, jr, p2, cfg.max_disp_levels)
        return jax.block_until_ready((d, out))

    dispatch()  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        dispatch()
        best = min(best, time.perf_counter() - t0)
    dev_fps = group_size / best

    variant = "lean" if device_rate_lean else "resident"
    print(json.dumps({
        "metric": f"st2_device_{h}x{w}_fps_{variant}",
        "value": dev_fps,
        "unit": f"frames/sec (phase1+phase2 dispatches; {variant} plan format)",
    }))
    print(json.dumps({
        "metric": f"st2_streaming_e2e_{h}x{w}_fps",
        "value": e2e_fps,
        "unit": "frames/sec",
    }))
    return dev_fps


if __name__ == "__main__":
    import sys

    run_st2_streaming_benchmark(
        device_rate_lean="--resident" not in sys.argv
    )
