"""ST-1 at HD (1280×720): proof the tree path scales in pixels.

Config-3 covered the D axis (128 disparities); this bench covers the pixel
axis — N = 921,600 nodes per tree, 5.8× the Middlebury scenes every other
ST number uses. The input is the Art pair bilinearly upscaled to 720p
(jittered per frame so every tree differs, as in st_streaming): synthetic
content, but the tree build, plan emission, transport, and filter see the
real HD workload shape.

Run: ``python -m gpu_stereo_matching_tpu.bench.st_hd``
"""

from __future__ import annotations

import json
import time

import numpy as np


def _fence(x):
    """Wait until ``x`` is computed on the device."""
    import jax

    return jax.block_until_ready(x)


def run_st_hd(
    group_size: int = 4, reps: int = 3, bands_list=(4, 8), workers: int = 4
) -> dict:
    import jax
    from PIL import Image

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.middlebury import load_middlebury_scene
    from gpu_stereo_matching_tpu.models.segment_tree import (
        _st1_device_group_jit,
    )
    from gpu_stereo_matching_tpu.tree.builder import (
        build_segment_tree,
        color_edge_weights,
    )
    from gpu_stereo_matching_tpu.tree.stride import (
        StridePlan,
        converged_stride_batch,
    )
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    cfg = SegmentTreeConfig()
    scene = load_middlebury_scene("/root/reference/Images", "Art")

    def up(img):
        return np.asarray(
            Image.fromarray(img).resize((1280, 720), Image.BILINEAR)
        )

    left, right = up(scene.left_bgr), up(scene.right_bgr)
    h, w = left.shape[:2]
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    frames = [(jitter(left), jitter(right)) for _ in range(group_size)]

    out = {"shape": f"{h}x{w}x{cfg.max_disp_levels}d", "group": group_size}

    t0 = time.perf_counter()
    trees = [
        build_segment_tree(color_edge_weights(f[0]), h, w) for f in frames
    ]
    out["tree_build_ms_per_frame"] = round(
        (time.perf_counter() - t0) / group_size * 1e3, 1
    )
    t0 = time.perf_counter()
    stacked = converged_stride_batch(trees, cfg.sigma)
    out["plan_emit_ms_per_frame"] = round(
        (time.perf_counter() - t0) / group_size * 1e3, 1
    )
    out["total_pos"] = stacked.total_pos
    out["pad_over_n"] = round(stacked.total_pos / (h * w), 3)
    out["plan_mb_per_frame"] = round(
        stacked.transport_nbytes / group_size / 1e6, 2
    )

    plans = stacked.to_device()
    jl = jax.device_put(np.stack([f[0] for f in frames]))
    jr = jax.device_put(np.stack([f[1] for f in frames]))
    _fence(jl[0, :1, :1])

    t0 = time.perf_counter()
    res = _st1_device_group_jit(jl, jr, plans, cfg.max_disp_levels)
    _fence(res)
    out["compile_plus_first_s"] = round(time.perf_counter() - t0, 1)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = _st1_device_group_jit(jl, jr, plans, cfg.max_disp_levels)
        _fence(res)
        best = min(best, time.perf_counter() - t0)
    out["device_ms_per_frame"] = round(best / group_size * 1e3, 2)
    out["device_fps"] = group_size / best
    global_out = np.asarray(res)
    print(json.dumps(out))

    # ---- Round 5: per-band trees (the HD host-solvency lever) ----------
    # B independent band trees per frame: the C++ build/emit parallelizes
    # across threads AND each tree's light-depth round count drops (the
    # super-linear device term at N≈1M). Accuracy vs the global tree is
    # reported as bad-2.0 of the banded output against the global output.
    from concurrent.futures import ThreadPoolExecutor

    from gpu_stereo_matching_tpu.models.segment_tree import (
        _st1_device_group_banded_jit,
    )
    from gpu_stereo_matching_tpu.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
    )

    import os as _os

    for bands in bands_list:
        ob = {
            "shape": out["shape"], "group": group_size, "bands": bands,
            # Host numbers are bounded by this container's core count
            # (2 vCPUs here): per-band work is embarrassingly parallel
            # C++ (~36 ms/band at bands=8), so a >=8-core production
            # host lands at ~build_serial/bands per frame.
            "host_cpus": _os.cpu_count(),
        }
        pipe = SegmentTreeBatchPipeline(
            cfg, group_size=group_size, workers=workers, bands=bands
        )
        with ThreadPoolExecutor(max_workers=workers) as pool:
            # warm (layout convergence + C++ lib load)
            pipe._host_build_group(frames, pool)
            t0 = time.perf_counter()
            _l, _r, stacked_b, _n = pipe._host_build_group(frames, pool)
            ob["host_ms_per_frame"] = round(
                (time.perf_counter() - t0) / group_size * 1e3, 1
            )
        ob["plan_mb_per_frame"] = round(
            stacked_b.transport_nbytes / group_size / 1e6, 2
        )
        pb = stacked_b.to_device()
        _fence(pb.ints[0, :1])
        resb = _st1_device_group_banded_jit(
            jl, jr, pb, cfg.max_disp_levels, bands
        )
        _fence(resb)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            resb = _st1_device_group_banded_jit(
                jl, jr, pb, cfg.max_disp_levels, bands
            )
            _fence(resb)
            best = min(best, time.perf_counter() - t0)
        ob["device_ms_per_frame"] = round(best / group_size * 1e3, 2)
        ob["device_fps"] = group_size / best
        diff = np.abs(
            np.asarray(resb).astype(np.int32) - global_out.astype(np.int32)
        )
        ob["bad2_vs_global_pct"] = round(float((diff > 2).mean() * 100), 3)
        ob["host_solvent"] = bool(
            ob["host_ms_per_frame"] <= ob["device_ms_per_frame"]
        )
        print(json.dumps(ob))
        out[f"bands{bands}"] = ob
    return out


if __name__ == "__main__":
    run_st_hd()
