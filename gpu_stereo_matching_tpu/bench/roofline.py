"""Roofline accounting for the hot kernels (north-star "speed of light").

Work is counted analytically from each kernel's own structure (itemized
below) and set against the peaks of the device it ran on, from
:data:`PEAKS`, which is keyed by ``jax.Device.device_kind``. A device that
is not in the table is an error, not a default.

Kernels covered:

1. **Fused SAD+WTA** (`kernels/sad_wta.py`, at its shipped tiles
   ``TILES``): per output row step a program calls ``edge`` twice (row
   entering, row leaving). Each call evaluates clipped AD costs at the
   entering and leaving columns of its ``block_w`` strip and over the
   ``kp = pow2(2r+1)`` columns of the window left of the strip, so per
   output pixel and disparity that is ``4 + 2·kp/block_w`` AD costs at
   ≈10 int32 operations each (address, three masks, load, widen,
   subtract, abs, two selects). On top: the edge differences and running
   sums (4), the left-of-strip sums (``2·kp/block_w``), the prefix sum
   along the strip (≈2·log₂(block_w)), and the SAD, packed key and min
   (5). At r=5, block_w=16 that is ≈79 int32 operations. Device memory
   sees each u8 image once and one int32 per output pixel; the shifted
   re-reads are served by L1/L2.
2. **Stride-bucket ST filter** (`tree/stride.py`): XLA row gathers, with
   the bytes every gathered row moves, plus 2 affine-scan passes (≈6
   operations per element per step) over the bucketed layout.

Run: ``python -m gpu_stereo_matching_tpu.bench.roofline --live`` measures
the fused kernel on the current GPU first; otherwise pass the measured
times and the device kind.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional

# Published peaks, dense, without sparsity. H100 SXM: NVIDIA H100 data
# sheet (3.35 TB/s HBM3, 67 TFLOP/s FP32 = 2 operations per FMA on 128
# FP32 lanes per SM, 900 GB/s NVLink = 450 GB/s each way). The Hopper
# white paper gives 64 INT32 lanes per SM, half the FP32 lanes, so the
# int32 rate is a quarter of the FP32 FLOP figure.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_ops_per_s": 67e12,
        "int32_ops_per_s": 67e12 / 4,
        "link_bytes_per_s": 450e9,
        "link": "NVLink (each way)",
        "source": "NVIDIA H100 SXM data sheet; Hopper architecture white paper",
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; raises for a device not in the table."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def sad_wta_ops_per_pixel_disparity(radius: int, block_w: int) -> float:
    """int32 operations per (output pixel, disparity) of the fused kernel."""
    kp = 1 << (2 * radius).bit_length()  # pow2 >= 2r+1, as in the kernel
    ad_costs = 4 + 2 * kp / block_w
    return ad_costs * 10 + 4 + 2 * kp / block_w + 2 * math.log2(block_w) + 5


def fused_sad_roofline(
    height: int, width: int, num_disp: int, radius: int, measured_ms: float,
    device_kind: str, block_w: Optional[int] = None,
) -> dict:
    """The kernel's time against its int32 and HBM bounds; ``block_w``
    defaults to the kernel's shipped tile."""
    from gpu_stereo_matching_tpu.kernels.sad_wta import TILES

    block_w = TILES["block_w"] if block_w is None else block_w
    peaks = device_peaks(device_kind)
    ops = height * width * num_disp * sad_wta_ops_per_pixel_disparity(radius, block_w)
    hbm_bytes = 2 * height * width + 4 * height * width
    t = measured_ms * 1e-3
    ops_bound = ops / peaks["int32_ops_per_s"]
    bytes_bound = hbm_bytes / peaks["hbm_bytes_per_s"]
    return {
        "kernel": "fused_sad_wta",
        "device_kind": device_kind,
        "shape": f"{height}x{width}x{num_disp}d_r{radius}",
        "measured_ms": measured_ms,
        "int32_ops": int(ops),
        "hbm_bytes": int(hbm_bytes),
        "bound": "int32 issue" if ops_bound >= bytes_bound else "HBM",
        "roofline_ms": max(ops_bound, bytes_bound) * 1e3,
        "roofline_share": max(ops_bound, bytes_bound) / t,
    }


def st_filter_roofline(plan, num_disp: int, measured_ms: float, device_kind: str) -> dict:
    """Gather-rows + scan-ops model for the stride-bucket filter."""
    peaks = device_peaks(device_kind)
    total = plan.total_pos
    n = plan.num_nodes
    hp = [sum(p for _e, p in row) for row in plan.buckets]
    live = plan.n_real if plan.n_real >= 0 else len(plan.buckets)
    gather_rows = (
        total          # perm in (cost -> plan order)
        + total        # per-round light pulls (destination-sized)
        + 2 * sum(hp[:live])  # head_perm reorders + down-pass parent pulls
        + n            # inv_perm out
    )
    scan_elems = sum(
        (1 << e) * p * e for row in plan.buckets[:live] for e, p in row
    )
    scan_ops = 2 * scan_elems * num_disp * 6  # up+down, a/b update FMAs
    row_bytes = num_disp * 4
    # Each gathered row is read and written once.
    gather_bound = 2 * gather_rows * row_bytes / peaks["hbm_bytes_per_s"]
    scan_bound = scan_ops / peaks["f32_ops_per_s"]
    t = measured_ms * 1e-3
    return {
        "kernel": "st_stride_filter",
        "device_kind": device_kind,
        "shape": f"N={n}_total={total}_D={num_disp}",
        "measured_ms": measured_ms,
        "gather_rows": int(gather_rows),
        "gather_hbm_bound_ms": gather_bound * 1e3,
        "scan_f32_ops": int(scan_ops),
        "scan_bound_ms": scan_bound * 1e3,
        "roofline_share": (gather_bound + scan_bound) / t,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--live", action="store_true",
                    help="measure the fused kernel on this GPU first")
    ap.add_argument("--device-kind", help="device kind of the measured runs")
    ap.add_argument("--sad-1080p-ms", type=float,
                    help="measured fused-kernel ms/frame at 1080p/64d/r=5")
    ap.add_argument("--st-ms", type=float,
                    help="measured stride-filter ms/frame (Art, 60 levels)")
    ap.add_argument("--middlebury-root", default=None,
                    help="Middlebury Images/ directory for the ST plan")
    args = ap.parse_args()

    if args.live:
        import jax

        import bench

        args.device_kind = jax.devices()[0].device_kind
        args.sad_1080p_ms = 1000.0 / bench.main()
    if args.device_kind is None or args.sad_1080p_ms is None:
        ap.error("pass --live, or --device-kind and --sad-1080p-ms")

    out = [fused_sad_roofline(1080, 1920, 64, 5, args.sad_1080p_ms, args.device_kind)]
    if args.middlebury_root and args.st_ms:
        from gpu_stereo_matching_tpu.io.middlebury import load_middlebury_scene
        from gpu_stereo_matching_tpu.tree.builder import (
            build_segment_tree,
            color_edge_weights,
        )
        from gpu_stereo_matching_tpu.tree.stride import StridePlan

        sc = load_middlebury_scene(args.middlebury_root, "Art")
        h, w = sc.left_bgr.shape[:2]
        tree = build_segment_tree(color_edge_weights(sc.left_bgr), h, w)
        plan = StridePlan.from_tree(tree, 0.1, device=False)
        out.append(st_filter_roofline(plan, 60, args.st_ms, args.device_kind))

    for row in out:
        print(json.dumps(row))
    return out


if __name__ == "__main__":
    main()
