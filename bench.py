"""Headline benchmark: block matching, 1080p / 64 disparities / r=5.

Prints one JSON line: frames/sec on one GPU through the main path
(``models.block_matching.sad_wta_disparity``, which runs the fused SAD+WTA
kernel there), batches of 8 frames per dispatch, each timing ended by
``block_until_ready``, best of 5, against the 60 fps north-star target
(BASELINE.md). The line names the device it ran on; without a GPU the
script fails instead of timing the CPU.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {dev.platform!r})")
    enable_jit_cache()

    from gpu_stereo_matching_tpu.models.block_matching import sad_wta_disparity

    rng = np.random.default_rng(0)
    b, h, w, d, r = 8, 1080, 1920, 64, 5
    left = jnp.asarray(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
    right = jnp.asarray(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
    step = jax.jit(lambda lb, rb: sad_wta_disparity(lb, rb, d, r))

    step(left, right).block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        step(left, right).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    fps = b / best

    baseline_fps = 60.0  # north-star target (the reference publishes none)
    print(
        json.dumps(
            {
                "metric": "block_matching_1080p_64disp_fps",
                "value": fps,
                "unit": "frames/sec",
                "vs_baseline": fps / baseline_fps,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    return fps


if __name__ == "__main__":
    main()
