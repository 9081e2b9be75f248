"""Command-line drivers mirroring the reference entry points.

* ``st``         — the STMatching CLI (``STMatching/main.cpp:40-67``):
                   left right out [max_disp] [scale] [sigma] [method]
* ``bm``         — the BlockMatching ``singleFrame`` demo generalized
                   (``BlockMatching/Caller.cpp:9-25``)
* ``rectify``    — the ``remapTest`` flow: calib YAML → rectification maps
                   → remapped pair (``Caller.cpp:27-74``)
* ``middlebury`` — dataset sweep with bad-2.0 metrics (GT was shipped but
                   unused in the reference)
* ``bench``      — headline throughput benchmark

Run: ``python -m gpu_stereo_matching_tpu.cli.main <command> ...``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _cmd_st(args) -> int:
    import jax.numpy as jnp  # noqa: F401  (ensure backend selected lazily)

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.images import load_image_bgr, save_image
    from gpu_stereo_matching_tpu.models.segment_tree import segment_tree_disparity

    cfg = SegmentTreeConfig(
        max_disp_levels=args.max_disp,
        disparity_scale=args.scale,
        sigma=args.sigma,
        iterate=(args.method == "st2"),
    )
    left = load_image_bgr(args.left)
    right = load_image_bgr(args.right)
    disp = segment_tree_disparity(left, right, cfg)
    save_image(args.out, disp)
    print(f"wrote {args.out} ({disp.shape[1]}x{disp.shape[0]}, scale {args.scale})")
    return 0


def _cmd_bm(args) -> int:
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.io.images import load_image_bgr, load_image_gray, save_image
    from gpu_stereo_matching_tpu.models.block_matching import (
        block_matching_pipeline,
        sad_wta_disparity,
    )
    from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr

    def load_gray(path):
        if args.gray:
            return jnp.asarray(load_image_gray(path))
        return gray_blockmatching_bgr(jnp.asarray(load_image_bgr(path)))

    left, right = load_gray(args.left), load_gray(args.right)
    if args.fused:
        disp = sad_wta_disparity(left, right, args.disparities, args.radius)
    else:
        cfg = BlockMatchingConfig(
            num_disparities=args.disparities,
            sad_radius=args.radius,
            lr_consistency=args.lr_check,
            median_radius=args.median_radius,
        )
        disp = block_matching_pipeline(left, right, cfg)
    out = np.asarray(disp)
    if args.colorize:
        from gpu_stereo_matching_tpu.io.visualize import colorize_disparity

        save_image(args.out, colorize_disparity(out, args.disparities))
    else:
        save_image(args.out, np.clip(out * args.scale, 0, 255).astype(np.uint8))
    print(f"wrote {args.out} (max disparity {int(out.max())})")
    return 0


def _cmd_rectify(args) -> int:
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.calib.rectify import rectification_maps_from_calibration
    from gpu_stereo_matching_tpu.io.calib_yaml import load_opencv_stereo_yaml
    from gpu_stereo_matching_tpu.io.images import (
        load_image_bgr,
        resize_bilinear_u8,
        save_image,
    )
    from gpu_stereo_matching_tpu.ops.color import gray_blockmatching_bgr
    from gpu_stereo_matching_tpu.ops.remap import remap_bilinear_u8

    calib = load_opencv_stereo_yaml(args.calib)
    left = load_image_bgr(args.left)
    right = load_image_bgr(args.right)
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
        # The reference's remapTest resizes to 320×200 but keeps the
        # 1280×800 intrinsics (Caller.cpp:35-51) — a known quirk we do not
        # replicate: intrinsics are rescaled to the target size unless
        # --keep-intrinsics asks for reference-faithful behavior.
        if not args.keep_intrinsics:
            calib = _scale_calibration(calib, h / left.shape[0])
        left = resize_bilinear_u8(left, (h, w))
        right = resize_bilinear_u8(right, (h, w))
    gl = gray_blockmatching_bgr(jnp.asarray(left))
    gr = gray_blockmatching_bgr(jnp.asarray(right))
    size_hw = gl.shape
    (lmx, lmy), (rmx, rmy) = rectification_maps_from_calibration(calib, size_hw)
    rect_l = np.asarray(remap_bilinear_u8(gl, jnp.asarray(lmx), jnp.asarray(lmy)))
    rect_r = np.asarray(remap_bilinear_u8(gr, jnp.asarray(rmx), jnp.asarray(rmy)))
    save_image(args.out_prefix + "_left.png", rect_l)
    save_image(args.out_prefix + "_right.png", rect_r)
    print(f"wrote {args.out_prefix}_left.png / _right.png ({size_hw[1]}x{size_hw[0]})")
    return 0


def _scale_calibration(calib, scale):
    if scale is None:
        return calib
    import dataclasses

    k1 = calib.left_intrinsics.copy()
    k2 = calib.right_intrinsics.copy()
    k1[:2] *= scale
    k2[:2] *= scale
    return dataclasses.replace(calib, left_intrinsics=k1, right_intrinsics=k2)


def _cmd_middlebury(args) -> int:
    from gpu_stereo_matching_tpu.bench.middlebury import run_middlebury_suite

    results = run_middlebury_suite(
        args.root,
        pipelines=args.pipelines.split(","),
        scenes=args.scenes.split(",") if args.scenes else None,
    )
    with_gt = [r for r in results if r.bad2 is not None]
    if with_gt:
        mean = float(np.mean([r.bad2 for r in with_gt]))
        print(f"mean bad-2.0 over {len(with_gt)} runs: {100 * mean:.2f}%")
    return 0


def _cmd_calibrate(args) -> int:
    """Stereo calibration from chessboard captures (the reference's
    ``CalibrationTest`` flow, ``Utility.cpp:97-196``, minus the interactive
    camera loop): native corner detection → Zhang mono + stereo
    calibration → OpenCV-format YAML."""
    import glob as globmod

    import numpy as np

    from gpu_stereo_matching_tpu.calib.zhang import (
        calibrate_camera,
        chessboard_object_points,
        detect_chessboard_corners,
        stereo_calibrate,
    )
    from gpu_stereo_matching_tpu.io.calib_yaml import (
        StereoCalibration,
        save_opencv_stereo_yaml,
    )
    from gpu_stereo_matching_tpu.io.images import load_image_gray

    lefts = sorted(globmod.glob(args.left_glob))
    rights = sorted(globmod.glob(args.right_glob))
    if len(lefts) != len(rights) or not lefts:
        print(f"unpaired captures: {len(lefts)} left vs {len(rights)} right")
        return 2
    lp, rp = [], []
    for lf, rf in zip(lefts, rights):
        lc = detect_chessboard_corners(
            np.asarray(load_image_gray(lf)), args.cols, args.rows,
            backend=args.backend,
        )
        rc = detect_chessboard_corners(
            np.asarray(load_image_gray(rf)), args.cols, args.rows,
            backend=args.backend,
        )
        status = "ok" if lc is not None and rc is not None else "skip"
        print(f"{lf} / {rf}: {status}")
        if lc is not None and rc is not None:
            lp.append(lc)
            rp.append(rc)
    if len(lp) < 3:
        print(f"only {len(lp)} usable pairs; need >= 3")
        return 1
    obj = chessboard_object_points(args.cols, args.rows, args.square_size)
    cl = calibrate_camera(obj, lp)
    cr = calibrate_camera(obj, rp)
    sc = stereo_calibrate(obj, lp, rp, cl, cr)
    print(
        f"left: fx={cl.intrinsics[0,0]:.1f} fy={cl.intrinsics[1,1]:.1f} "
        f"cx={cl.intrinsics[0,2]:.1f} cy={cl.intrinsics[1,2]:.1f} "
        f"rms={cl.rms_error:.3f}px"
    )
    print(
        f"right: fx={cr.intrinsics[0,0]:.1f} fy={cr.intrinsics[1,1]:.1f} "
        f"cx={cr.intrinsics[0,2]:.1f} cy={cr.intrinsics[1,2]:.1f} "
        f"rms={cr.rms_error:.3f}px"
    )
    print(f"stereo: |T|={np.linalg.norm(sc.translation):.2f} rms={sc.rms_error:.3f}px")
    save_opencv_stereo_yaml(
        args.out,
        StereoCalibration(
            left_intrinsics=cl.intrinsics,
            right_intrinsics=cr.intrinsics,
            left_distortion=cl.distortion,
            right_distortion=cr.distortion,
            rotation=sc.rotation,
            translation=sc.translation,
        ),
    )
    print(f"wrote {args.out} ({len(lp)} pairs)")
    return 0


def _cmd_bench(args) -> int:
    import bench

    bench.main()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpu_stereo_matching_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    st = sub.add_parser("st", help="segment-tree stereo (ST-1/ST-2)")
    st.add_argument("left")
    st.add_argument("right")
    st.add_argument("out")
    st.add_argument("--max-disp", type=int, default=60)
    st.add_argument("--scale", type=int, default=4)
    st.add_argument("--sigma", type=float, default=0.1)
    st.add_argument("--method", choices=["st1", "st2"], default="st1")
    st.set_defaults(fn=_cmd_st)

    bm = sub.add_parser("bm", help="SAD block matching")
    bm.add_argument("left")
    bm.add_argument("right")
    bm.add_argument("out")
    bm.add_argument("--disparities", type=int, default=64)
    bm.add_argument("--radius", type=int, default=5)
    bm.add_argument("--scale", type=int, default=4)
    bm.add_argument("--gray", action="store_true", help="inputs already gray")
    bm.add_argument(
        "--fused", action="store_true",
        help="SAD+WTA only, through the fused kernel on a GPU",
    )
    bm.add_argument("--lr-check", action="store_true")
    bm.add_argument("--median-radius", type=int, default=0)
    bm.add_argument("--colorize", action="store_true", help="turbo-colormap output")
    bm.set_defaults(fn=_cmd_bm)

    rect = sub.add_parser("rectify", help="calibrated rectification + remap")
    rect.add_argument("--calib", required=True)
    rect.add_argument("--left", required=True)
    rect.add_argument("--right", required=True)
    rect.add_argument("--out-prefix", required=True)
    rect.add_argument("--size", help="WxH resize before rectification")
    rect.add_argument(
        "--keep-intrinsics",
        action="store_true",
        help="do not rescale intrinsics on --size (reference-faithful quirk)",
    )
    rect.set_defaults(fn=_cmd_rectify)

    mb = sub.add_parser("middlebury", help="dataset sweep with bad-2.0")
    mb.add_argument("--root", default="/root/reference/Images")
    mb.add_argument("--pipelines", default="bm,st1")
    mb.add_argument("--scenes", default=None)
    mb.set_defaults(fn=_cmd_middlebury)

    cal = sub.add_parser(
        "calibrate", help="stereo calibration from chessboard captures"
    )
    cal.add_argument("left_glob", help="glob for left captures")
    cal.add_argument("right_glob", help="glob for right captures")
    cal.add_argument("out", help="output calibration YAML")
    cal.add_argument("--cols", type=int, default=14, help="inner corners per row")
    cal.add_argument("--rows", type=int, default=14, help="inner corner rows")
    cal.add_argument("--square-size", type=float, default=1.0)
    cal.add_argument(
        "--backend", choices=("native", "opencv"), default="native"
    )
    cal.set_defaults(fn=_cmd_calibrate)

    be = sub.add_parser("bench", help="headline throughput benchmark")
    be.set_defaults(fn=_cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Persistent XLA compile cache: without it every CLI invocation pays
    # full recompiles of every pipeline it runs.
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    enable_jit_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
