"""Native chessboard detection + calibration YAML writer."""

import os

import numpy as np
import pytest

from gpu_stereo_matching_tpu.calib.chessboard import (
    detect_chessboard_corners_native,
    refine_corners_subpix,
    saddle_response,
)


def render_board(cols, rows, square=24, h_mat=None, size=None, noise=0.0, rng=None):
    """Synthetic chessboard image + ground-truth inner corners.

    ``cols × rows`` inner corners = (cols+1) × (rows+1) squares plus a
    white margin, optionally warped by a homography (pixels sampled at
    4× supersampling through the inverse map for clean saddle shapes).
    """
    bw = (cols + 1) * square
    bh = (rows + 1) * square
    margin = square
    if size is None:
        size = (bh + 2 * margin + 40, bw + 2 * margin + 40)
    if h_mat is None:
        h_mat = np.array([[1.0, 0.02, 20.0], [0.015, 1.0, 22.0], [0, 0, 1.0]])
    hi, wi = size
    ss = 4
    # supersample positions centered on integer pixel coordinates
    yy, xx = (np.mgrid[0 : hi * ss, 0 : wi * ss] + 0.5) / ss - 0.5
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)])
    hinv = np.linalg.inv(h_mat)
    src = hinv @ pts
    sx = src[0] / src[2] - margin
    sy = src[1] / src[2] - margin
    inside = (sx >= 0) & (sx < bw) & (sy >= 0) & (sy < bh)
    cell = (np.floor(sx / square).astype(int) + np.floor(sy / square).astype(int)) % 2
    vals = np.where(inside & (cell == 0), 40.0, 215.0)
    img = vals.reshape(hi * ss, wi * ss)
    img = img.reshape(hi, ss, wi, ss).mean((1, 3))
    # slight optical blur (subpixel refinement assumes smooth edges, as a
    # real lens produces)
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(img, 0.8)
    if noise and rng is not None:
        img = img + rng.normal(0, noise, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)

    gx, gy = np.meshgrid(np.arange(1, cols + 1), np.arange(1, rows + 1))
    corners = np.stack(
        [gx.ravel() * square + margin, gy.ravel() * square + margin,
         np.ones(cols * rows)]
    )
    proj = h_mat @ corners
    gt = (proj[:2] / proj[2]).T  # raster order: rows of `cols`
    return img, gt


def _match_sets(got, want, tol):
    from scipy.spatial import cKDTree

    d, _ = cKDTree(got).query(want)
    return d.max() <= tol


def test_detect_synthetic_square_board(rng):
    img, gt = render_board(8, 8, noise=2.0, rng=rng)
    got = detect_chessboard_corners_native(img, 8, 8)
    assert got is not None and got.shape == (64, 2)
    assert _match_sets(got, gt, 0.5)


def test_detect_synthetic_nonsquare_board(rng):
    img, gt = render_board(9, 6, noise=1.0, rng=rng)
    got = detect_chessboard_corners_native(img, 9, 6)
    assert got is not None and got.shape == (54, 2)
    assert _match_sets(got, gt, 0.5)
    # Raster ordering: consecutive corners within a row are one square
    # apart; row strides are consistent.
    rows = got.reshape(6, 9, 2)
    steps = np.diff(rows, axis=1).reshape(-1, 2)
    assert np.linalg.norm(steps.std(axis=0)) < 2.0


def test_detect_orientation_canonical(rng):
    """A rotated capture of the same board yields the same corner SET and
    a deterministic raster direction (row direction ~ +x)."""
    img, _ = render_board(8, 8, noise=1.0, rng=rng)
    got = detect_chessboard_corners_native(img, 8, 8)
    rot = np.ascontiguousarray(np.rot90(img, 2))
    got_rot = detect_chessboard_corners_native(rot, 8, 8)
    assert got is not None and got_rot is not None
    # map rotated detections back into original frame
    h, w = img.shape
    back = np.stack([w - 1 - got_rot[:, 0], h - 1 - got_rot[:, 1]], 1)
    np.testing.assert_allclose(np.sort(back, axis=0), np.sort(got, axis=0),
                               atol=0.5)
    # canonical raster: row direction points along +x in both
    assert (got[1] - got[0])[0] > 0
    assert (got_rot[1] - got_rot[0])[0] > 0


def test_detect_rejects_blank_and_noise(rng):
    blank = np.full((120, 160), 128, np.uint8)
    assert detect_chessboard_corners_native(blank, 8, 8) is None
    noise = rng.integers(0, 256, (120, 160), dtype=np.uint8)
    assert detect_chessboard_corners_native(noise, 8, 8) is None


def test_subpix_refine_converges_on_ideal_saddle():
    yy, xx = np.mgrid[0:41, 0:41].astype(np.float64)
    img = 128 + 100 * np.tanh((xx - 20.3) / 2) * np.tanh((yy - 19.6) / 2)
    pts, ok = refine_corners_subpix(img.astype(np.float32), [(19.0, 21.0)])
    assert ok[0]
    np.testing.assert_allclose(pts[0], [20.3, 19.6], atol=0.1)


def test_saddle_response_peaks_at_corner():
    img, gt = render_board(4, 4)
    resp = saddle_response(img.astype(np.float32), 4)
    y, x = np.unravel_index(np.argmax(resp), resp.shape)
    d = np.hypot(gt[:, 0] - x, gt[:, 1] - y).min()
    assert d < 2.5


def test_real_chess_capture_matches_opencv(reference_chess_root):
    cv2 = pytest.importorskip("cv2")
    from PIL import Image
    from scipy.spatial import cKDTree

    im = np.asarray(
        Image.open(
            os.path.join(reference_chess_root, "Set2", "Left_10.jpg")
        ).convert("L")
    )
    got = detect_chessboard_corners_native(im, 14, 14)
    assert got is not None and got.shape == (196, 2)
    ok, cc = cv2.findChessboardCorners(
        im, (14, 14),
        flags=cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_NORMALIZE_IMAGE,
    )
    assert ok
    d, _ = cKDTree(got).query(cc.reshape(-1, 2))
    assert np.median(d) < 1.0


def test_calib_yaml_roundtrip(tmp_path, rng):
    from gpu_stereo_matching_tpu.io.calib_yaml import (
        StereoCalibration,
        load_opencv_stereo_yaml,
        save_opencv_stereo_yaml,
    )

    calib = StereoCalibration(
        left_intrinsics=np.array([[1100.5, 0, 640.2], [0, 1099.0, 360.7], [0, 0, 1]]),
        right_intrinsics=np.array([[1102.1, 0, 644.9], [0, 1101.3, 351.0], [0, 0, 1]]),
        left_distortion=np.array([0.1, -0.2, 0.001, -0.002, 0.05]),
        right_distortion=np.array([0.11, -0.22, 0.0, 0.0, 0.01]),
        rotation=np.eye(3) + rng.normal(0, 1e-3, (3, 3)),
        translation=np.array([-46.99, -0.11, -0.24]),
    )
    path = tmp_path / "calib.yml"
    save_opencv_stereo_yaml(path, calib)
    back = load_opencv_stereo_yaml(path)
    for field in (
        "left_intrinsics", "right_intrinsics", "left_distortion",
        "right_distortion", "rotation", "translation",
    ):
        np.testing.assert_array_equal(getattr(back, field), getattr(calib, field))
