"""Calibrated-rig streaming throughput (BASELINE config 4).

End-to-end per frame: BGR → gray → bilinear remap through cached
rectification maps → block matching (the fused kernel on a GPU). Measured
as one dispatch over a resident frame batch (steady-state streaming),
ended by ``block_until_ready``.
"""

from __future__ import annotations

import json
import time

import numpy as np


def run_streaming_benchmark(
    calib_path: str = "/root/reference/Calib_Data_OpenCV.yml",
    height: int = 720,
    width: int = 1280,
    calib_size_hw=(800, 1280),
    num_frames: int = 16,
    num_disparities: int = 64,
    radius: int = 5,
) -> float:
    import jax

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.models.streaming import rig_from_yaml

    rig = rig_from_yaml(
        calib_path,
        (height, width),
        BlockMatchingConfig(num_disparities=num_disparities, sad_radius=radius),
        scale_intrinsics_from=calib_size_hw,
    )
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    lb = jnp.asarray(
        rng.integers(0, 256, (num_frames, height, width, 3), dtype=np.uint8)
    )
    rb = jnp.asarray(
        rng.integers(0, 256, (num_frames, height, width, 3), dtype=np.uint8)
    )
    jax.block_until_ready((lb, rb))

    # Steady-state device throughput: frames already resident (as in a
    # double-buffered capture pipeline), one dispatch per batch.
    def run():
        return rig.process_batch(lb, rb).block_until_ready()

    run()  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    fps = num_frames / best
    print(
        json.dumps(
            {
                "metric": f"rig_streaming_{height}p_{num_disparities}disp_fps",
                "value": fps,
                "unit": "frames/sec",
            }
        )
    )
    return fps


if __name__ == "__main__":
    run_streaming_benchmark()
