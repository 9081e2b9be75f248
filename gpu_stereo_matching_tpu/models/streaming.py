"""Calibrated-rig streaming pipeline: rectify → remap → fused block matching.

The production analog of the reference's ``remapTest`` + ``singleFrame``
demos (``BlockMatching/Caller.cpp``) as one engine: rectification maps are
precomputed once per calibration (host, cached), and every frame pair runs
a single jitted device program — gray conversion, bilinear remap through
the maps (XLA's gather), and block matching (the fused SAD+WTA kernel on
the GPU, see :func:`models.block_matching.block_matching_frame`) — so
steady-state streaming has zero host-side math and one dispatch per frame
(or per batch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gpu_stereo_matching_tpu.calib.rectify import rectification_maps_from_calibration
from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.io.calib_yaml import StereoCalibration
from gpu_stereo_matching_tpu.models.block_matching import block_matching_frame
from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr
from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8
from gpu_stereo_matching_tpu.utils.cache import ArtifactCache, content_key
from gpu_stereo_matching_tpu.utils.profiling import StageTimer


class StereoRig:
    """Streaming disparity engine for one calibrated stereo rig."""

    def __init__(
        self,
        calib: StereoCalibration,
        image_size_hw: Tuple[int, int],
        config: BlockMatchingConfig = BlockMatchingConfig(),
        cache: Optional[ArtifactCache] = None,
    ) -> None:
        self.config = config
        self.image_size_hw = image_size_hw
        cache = cache or ArtifactCache()
        key = content_key(
            "rectify-maps",
            calib.left_intrinsics, calib.left_distortion,
            calib.right_intrinsics, calib.right_distortion,
            calib.rotation, calib.translation, image_size_hw,
        )
        (lmx, lmy), (rmx, rmy) = cache.get_or_compute(
            key, lambda: rectification_maps_from_calibration(calib, image_size_hw)
        )
        self._maps = tuple(jnp.asarray(m) for m in (lmx, lmy, rmx, rmy))

        def rectify(left_bgr, right_bgr, lmx, lmy, rmx, rmy):
            return (
                remap_bilinear_u8(gray_blockmatching_bgr(left_bgr), lmx, lmy),
                remap_bilinear_u8(gray_blockmatching_bgr(right_bgr), rmx, rmy),
            )

        def frame_step(left_bgr, right_bgr, *maps):
            return block_matching_frame(*rectify(left_bgr, right_bgr, *maps), config)

        def batched(step):
            return jax.jit(
                lambda lb, rb, *maps: jax.lax.map(
                    lambda lr: step(lr[0], lr[1], *maps), (lb, rb)
                )
            )

        self._frame_step = jax.jit(frame_step)
        self._batch_step = batched(frame_step)
        self._rectify_batch = batched(rectify)

    def process(self, left_bgr, right_bgr, timer: Optional[StageTimer] = None):
        """One (H, W, 3) uint8 BGR pair → (H, W) int32 disparity."""
        out = self._frame_step(jnp.asarray(left_bgr), jnp.asarray(right_bgr), *self._maps)
        if timer is not None:
            with timer.stage("frame", fence=out):
                pass
        return out

    def process_batch(self, left_bgr, right_bgr):
        """(B, H, W, 3) uint8 BGR batches → (B, H, W) int32 disparities."""
        return self._batch_step(
            jnp.asarray(left_bgr), jnp.asarray(right_bgr), *self._maps
        )

    def rectify_batch(self, left_bgr, right_bgr):
        """(B, H, W, 3) uint8 BGR batches → the rectified (B, H, W) uint8
        gray pair that :meth:`process_batch` matches."""
        return self._rectify_batch(
            jnp.asarray(left_bgr), jnp.asarray(right_bgr), *self._maps
        )


def rig_from_yaml(
    path: str,
    image_size_hw: Tuple[int, int],
    config: BlockMatchingConfig = BlockMatchingConfig(),
    scale_intrinsics_from: Optional[Tuple[int, int]] = None,
) -> StereoRig:
    """Build a rig from an OpenCV calibration YAML.

    ``scale_intrinsics_from``: original calibration resolution (H, W) if the
    rig runs at a different ``image_size_hw`` (intrinsics are rescaled).
    """
    import dataclasses as dc

    from gpu_stereo_matching_tpu.io.calib_yaml import load_opencv_stereo_yaml

    calib = load_opencv_stereo_yaml(path)
    if scale_intrinsics_from is not None:
        sy = image_size_hw[0] / scale_intrinsics_from[0]
        sx = image_size_hw[1] / scale_intrinsics_from[1]
        k1 = calib.left_intrinsics.copy()
        k2 = calib.right_intrinsics.copy()
        k1[0] *= sx
        k1[1] *= sy
        k2[0] *= sx
        k2[1] *= sy
        calib = dc.replace(calib, left_intrinsics=k1, right_intrinsics=k2)
    return StereoRig(calib, image_size_hw, config)
