"""Ad-hoc A/B: stride-bucket vs coded plan-order ST-1 device rate.

Mimics bench/st_profile.py's methodology: group dispatch on pre-uploaded
data, ended by ``block_until_ready``, best of N reps.
"""

import json
import sys
import time

import numpy as np


def _fence(x):
    """Wait until ``x`` is computed on the device."""
    import jax

    return jax.block_until_ready(x)


def main(group_size=8, reps=4):
    import jax

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.middlebury import load_middlebury_scene
    from gpu_stereo_matching_tpu.models.segment_tree import (
        _st1_device_group_jit,
    )
    from gpu_stereo_matching_tpu.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
    )
    from gpu_stereo_matching_tpu.tree.builder import (
        build_segment_tree,
        color_edge_weights,
    )
    from gpu_stereo_matching_tpu.tree.hpd import stack_coded_plans
    from gpu_stereo_matching_tpu.tree.stride import (
        StridePlan,
        converged_stride_batch,
    )
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    cfg = SegmentTreeConfig()
    scene = load_middlebury_scene("/root/reference/Images", "Art")
    left, right = np.asarray(scene.left_bgr), np.asarray(scene.right_bgr)
    rng = np.random.default_rng(0)

    def jitter(img):
        noise = rng.integers(-6, 7, img.shape, dtype=np.int16)
        return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    frames = [(jitter(left), jitter(right)) for _ in range(group_size)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    jl, jr = jax.device_put(lefts), jax.device_put(rights)
    _fence(jl[0, :1, :1])
    h, w = left.shape[:2]

    out = {}
    trees = [
        build_segment_tree(color_edge_weights(f[0]), h, w) for f in frames
    ]

    for mode in sys.argv[1:] or ["stride", "coded"]:
        if mode == "stride":
            t0 = time.perf_counter()
            stacked = converged_stride_batch(trees, cfg.sigma)
            out["stride_host_ms_per_frame"] = (
                (time.perf_counter() - t0) / group_size * 1e3
            )
            plans = stacked.to_device()
        else:
            from gpu_stereo_matching_tpu.tree.hpd import CodedPlan

            cps = [
                CodedPlan.from_tree(t, cfg.sigma, device=False) for t in trees
            ]
            for _ in range(4):
                if len({p.layout_key for p in cps}) == 1:
                    break
                cps = [
                    CodedPlan.from_tree(t, cfg.sigma, device=False)
                    for t in trees
                ]
            stacked = stack_coded_plans(cps)
            plans = CodedPlan(
                stacked.num_nodes, stacked.total_pos, stacked.rounds_meta,
                jax.device_put(stacked.ints), jax.device_put(stacked.codes),
                jax.device_put(np.asarray(stacked.table)),
                stacked.scan_steps, stacked.n_real,
            )
        out[f"{mode}_plan_mb"] = (
            stacked.transport_nbytes
            if mode == "stride"
            else np.asarray(stacked.ints).nbytes
            + np.asarray(stacked.codes).nbytes
        ) / 1e6 / group_size
        t0 = time.perf_counter()
        res = _st1_device_group_jit(jl, jr, plans, cfg.max_disp_levels)
        _fence(res)
        out[f"{mode}_compile_s"] = time.perf_counter() - t0
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res = _st1_device_group_jit(jl, jr, plans, cfg.max_disp_levels)
            _fence(res)
            best = min(best, time.perf_counter() - t0)
        out[f"{mode}_device_ms_per_frame"] = best * 1e3 / group_size
        out[f"{mode}_fps"] = group_size / best
        out[f"{mode}_checksum"] = int(np.asarray(res, np.int64).sum())

    print(json.dumps({k: round(v, 3) for k, v in out.items()}))


if __name__ == "__main__":
    main()
