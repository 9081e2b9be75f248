"""Micro-benchmarks of individual stages (the reference's pattern).

Mirrors ``cvtColorTest`` — 1000-iteration CPU vs library vs device timing
of gray conversion (``BlockMatching/Caller.cpp:76-112``) — and the timed
remap/upload/download stages of ``blockMatching_gpu``
(``Device.cu:204-292``), generalized into a small registry of stage
benchmarks with structured output.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np

import jax
import jax.numpy as jnp


def _time(fn: Callable[[], object], iters: int) -> float:
    jax.block_until_ready(fn())  # warm / compile
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def run_micro_benchmarks(
    height: int = 1080, width: int = 1920, iters: int = 100
) -> Dict[str, float]:
    """Per-stage seconds on the default device; printed as ms alongside a
    NumPy host reference."""
    from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr, gradient_x
    from gpu_stereo_matching_tpu.ops.postprocess import median_filter_u8
    from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8

    rng = np.random.default_rng(0)
    img_bgr = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (height, width), dtype=np.uint8)
    map_x = (rng.random((height, width)) * width).astype(np.float32)
    map_y = (rng.random((height, width)) * height).astype(np.float32)

    j_bgr = jnp.asarray(img_bgr)
    j_gray = jnp.asarray(gray)
    j_mx, j_my = jnp.asarray(map_x), jnp.asarray(map_y)

    gray_jit = jax.jit(gray_blockmatching_bgr)
    grad_jit = jax.jit(gradient_x)
    remap_jit = jax.jit(remap_bilinear_u8)
    median_jit = jax.jit(lambda x: median_filter_u8(x, 3))

    results = {
        "gray_cpu_numpy": _time(
            lambda: np.clip(
                np.rint(img_bgr.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)),
                0, 255,
            ).astype(np.uint8),
            max(iters // 10, 1),
        ),
        "gray_device": _time(lambda: gray_jit(j_bgr), iters),
        "gradient_device": _time(lambda: grad_jit(j_gray), iters),
        "remap_device": _time(lambda: remap_jit(j_gray, j_mx, j_my), iters),
        "median7x7_device": _time(lambda: median_jit(j_gray), max(iters // 10, 1)),
        "h2d_upload": _time(lambda: jnp.asarray(gray).block_until_ready(), iters),
        "d2h_download": _time(lambda: np.asarray(j_gray), iters),
    }

    # Block matching through the main path (the fused kernel on a GPU)
    # against the plain XLA pipeline: the cost of materializing the
    # (D, H, W) cost and SAD volumes in device memory.
    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.models.block_matching import (
        block_matching_pipeline,
        sad_wta_disparity,
    )

    j_right = jnp.asarray(
        rng.integers(0, 256, (height, width), dtype=np.uint8)
    )
    num_disp = min(64, width)  # tiny test shapes can't cover 64 disparities
    cfg = BlockMatchingConfig(num_disparities=num_disp, sad_radius=5)
    main_jit = jax.jit(lambda l, r: sad_wta_disparity(l, r, num_disp, 5))
    slow = max(iters // 10, 1)
    results["bm_main_path"] = _time(lambda: main_jit(j_gray, j_right), slow)
    results["bm_xla_pipeline"] = _time(
        lambda: block_matching_pipeline(j_gray, j_right, cfg), slow
    )
    # Large-radius median: the 255-pass histogram CDF (plain XLA).
    if min(height, width) > 10:
        cdf = jax.jit(lambda x: median_filter_u8(x, 5, method="histogram"))
        results["median_r5_histogram"] = _time(lambda: cdf(j_gray), slow)

    for name, secs in results.items():
        print(f"{name:24s} {secs * 1e3:9.3f} ms")
    return results


if __name__ == "__main__":
    run_micro_benchmarks()
