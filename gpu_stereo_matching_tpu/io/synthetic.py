"""Seeded synthetic stereo scenes with ground truth (host side, NumPy).

A textured left image and a right image warped from it through a
piecewise-constant disparity field: a background plane and a few nearer
rectangles, each at its own disparity. Where a nearer rectangle hides what
the left camera sees, the left pixel is *occluded* (a band beside each
rectangle); right-image pixels that nothing maps to are filled with fresh
texture. Everything is a function of the seed, so a run needs no files.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticScene:
    left: np.ndarray       # (H, W) or (H, W, 3) uint8 (BGR for 3 channels)
    right: np.ndarray      # same shape and dtype
    disparity: np.ndarray  # (H, W) int32 ground truth of the left view
    valid: np.ndarray      # (H, W) bool: visible in both views (not occluded)


def _texture(rng: np.random.Generator, shape) -> np.ndarray:
    """Smooth-ish random texture: uniform noise under a 3×3 box blur."""
    noise = rng.integers(0, 256, shape, dtype=np.int32)
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (len(shape) - 2)
    p = np.pad(noise, pad, mode="edge")
    h, w = shape[:2]
    acc = sum(p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3))
    return (acc // 9).astype(np.uint8)


def make_stereo_scene(
    seed: int,
    height: int,
    width: int,
    num_disparities: int,
    channels: int = 1,
    num_objects: int = 6,
) -> SyntheticScene:
    """A (height, width) scene whose disparities lie in [0, num_disparities).

    ``channels`` is 1 (gray, (H, W) images) or 3 (BGR, (H, W, 3) images).
    """
    if channels not in (1, 3):
        raise ValueError("channels must be 1 or 3")
    if num_disparities < 2:
        raise ValueError("num_disparities must be >= 2")
    rng = np.random.default_rng(seed)
    shape = (height, width) if channels == 1 else (height, width, 3)
    left = _texture(rng, shape)

    top = num_disparities - 1
    disp = np.full((height, width), int(rng.integers(0, max(1, top // 4) + 1)), np.int32)
    for _ in range(num_objects):
        h = int(rng.integers(max(1, height // 8), max(2, height // 3)))
        w = int(rng.integers(max(1, width // 8), max(2, width // 3)))
        y = int(rng.integers(0, height - h + 1))
        x = int(rng.integers(0, width - w + 1))
        disp[y : y + h, x : x + w] = int(rng.integers(top // 4, top + 1))

    # Forward-warp left → right far to near, so nearer surfaces win.
    right = _texture(rng, shape)
    owner = np.full((height, width), -1, np.int32)
    ys, xs = np.indices((height, width))
    for d in np.unique(disp):
        sel = (disp == d) & (xs >= d)
        right[ys[sel], xs[sel] - d] = left[sel]
        owner[ys[sel], xs[sel] - d] = d
    src = np.clip(xs - disp, 0, width - 1)
    valid = (xs >= disp) & (owner[ys, src] == disp)
    return SyntheticScene(left=left, right=right, disparity=disp, valid=valid)


def bad_pixel_rate(
    disparity: np.ndarray, scene: SyntheticScene, threshold: float = 2.0
) -> float:
    """Share of visible pixels whose disparity is off by more than
    ``threshold`` levels (Middlebury's bad-2.0 with the default)."""
    err = np.abs(np.asarray(disparity, np.float64) - scene.disparity)
    return float(np.mean(err[scene.valid] > threshold))
