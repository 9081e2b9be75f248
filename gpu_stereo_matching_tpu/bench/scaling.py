"""Scaling-efficiency harness: fps vs. mesh size (BASELINE config 5).

Two parts:

* :func:`run_scaling_benchmark` measures the sharded block-matching step
  over mesh factorizations (data / space / disp). Across hosts this is
  launched per host via :mod:`parallel.launch`; in tests it runs on the
  virtual CPU mesh (functional scaling only — CPU fps is not a device
  number).
* :func:`predict_scaling_efficiency` puts arithmetic behind the ≥85%
  multi-device target: per-frame communication volume of every sharding
  strategy this framework implements, against a measured per-frame
  compute time and the device's published link rate
  (``bench.roofline.PEAKS``). The model is deliberately conservative:
  collectives are assumed fully EXPOSED (no comm/compute overlap),
  ring-schedule costs use the standard 2·(p−1)/p factor, and the rates
  are parameters so a deployment can re-run the prediction with its own
  numbers.

Run: ``python -m gpu_stereo_matching_tpu.bench.scaling --compute-ms X``
with X the measured fused-kernel ms/frame at 1080p (or ``--live`` to
measure it on this GPU); ``--measure`` also runs the mesh sweep.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig, MeshConfig
from gpu_stereo_matching_tpu.parallel.mesh import build_mesh
from gpu_stereo_matching_tpu.parallel.stereo import (
    make_sharded_block_matching,
    shard_batch,
)


@dataclasses.dataclass
class ScalingPoint:
    mesh: dict
    devices: int
    fps: float
    efficiency: Optional[float]  # vs the 1-device point, per device


def _measure(mesh_cfg: MeshConfig, bm: BlockMatchingConfig, num_frames, h, w) -> float:
    mesh = build_mesh(mesh_cfg)
    step = make_sharded_block_matching(mesh, bm)
    rng = np.random.default_rng(0)
    left = jnp.asarray(rng.integers(0, 256, (num_frames, h, w), dtype=np.uint8))
    right = jnp.asarray(rng.integers(0, 256, (num_frames, h, w), dtype=np.uint8))
    jl, jr = shard_batch(mesh, left, right)
    step(jl, jr).block_until_ready()  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        step(jl, jr).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return num_frames / best


def run_scaling_benchmark(
    full_mesh: MeshConfig,
    bm: BlockMatchingConfig = BlockMatchingConfig(),
    num_frames: int = 16,
    height: int = 1080,
    width: int = 1920,
) -> List[ScalingPoint]:
    """Sweep 1 device → full mesh along the data axis; print JSON lines."""
    points: List[ScalingPoint] = []
    base_fps = None
    data = 1
    while data <= full_mesh.data:
        cfg = MeshConfig(data=data, space=full_mesh.space, disp=full_mesh.disp)
        frames = max(num_frames, cfg.num_devices)
        frames -= frames % cfg.num_devices or 0
        fps = _measure(cfg, bm, max(frames, cfg.data), height, width)
        eff = None
        if base_fps is None:
            base_fps = fps / cfg.num_devices
        else:
            eff = fps / (cfg.num_devices * base_fps)
        pt = ScalingPoint(
            mesh=dict(zip(cfg.axis_names, cfg.shape)),
            devices=cfg.num_devices,
            fps=round(fps, 2),
            efficiency=None if eff is None else round(eff, 3),
        )
        points.append(pt)
        print(json.dumps(dataclasses.asdict(pt)))
        data *= 2
    return points


# ---------------------------------------------------------------------------
# Predicted scaling efficiency from comm-volume arithmetic.
# ---------------------------------------------------------------------------

# One 400 Gb/s InfiniBand NDR port per host: the network between hosts
# (a parameter; re-run with the deployment's own rate).
NETWORK_BYTES_PER_S = 50e9


def predict_scaling_efficiency(
    compute_ms_per_frame: float,
    device_kind: str = "NVIDIA H100 80GB HBM3",
    h: int = 1080,
    w: int = 1920,
    sad_radius: int = 5,
    median_radius: int = 3,
    n_chips: int = 8,
    n_hosts: int = 2,
    network_bytes_per_s: float = NETWORK_BYTES_PER_S,
) -> List[dict]:
    """Predict per-strategy scaling efficiency for BASELINE config 5.

    Efficiency model: ``eff = t_compute / (t_compute + t_comm)`` with
    ``t_compute = compute_ms / p`` (perfect split) and ``t_comm`` the
    fully-exposed transfer time of that strategy's per-frame collectives.
    Every byte count below is derivable from the shard_map programs in
    ``parallel/stereo.py`` / ``parallel/segment_tree.py``.
    """
    from gpu_stereo_matching_tpu.bench.roofline import device_peaks

    link_bytes_per_s = device_peaks(device_kind)["link_bytes_per_s"]
    t_comp = compute_ms_per_frame / n_chips * 1e-3  # seconds, per chip

    rows: List[dict] = []

    def add(strategy, link, bw, bytes_per_frame, note):
        t_comm = bytes_per_frame / bw
        eff = t_comp / (t_comp + t_comm)
        rows.append({
            "strategy": strategy,
            "link": link,
            "comm_bytes_per_frame": int(bytes_per_frame),
            "t_compute_us": round(t_comp * 1e6, 1),
            "t_comm_us": round(t_comm * 1e6, 2),
            "predicted_efficiency": round(eff, 4),
            "meets_85pct": bool(eff >= 0.85),
            "note": note,
        })

    # Data parallel over frames: zero per-frame collectives (inputs are
    # host-fed per shard; outputs fetched per shard), within or across hosts.
    add(
        "data_parallel", "none", link_bytes_per_s, 0,
        "frame sharding, parallel/stereo.py shard_batch — no collective",
    )

    # Space (H-band) sharding: ring halo exchange of the two u8 input
    # images, `halo` rows of W bytes to each neighbor, both directions
    # (parallel/halo.py extend_with_row_halos). Per chip per frame.
    halo = sad_radius  # plain config-1/5 BM
    halo_bytes = 2 * 2 * halo * w  # 2 images x 2 directions
    add(
        "space_bm", "NVLink", link_bytes_per_s, halo_bytes,
        f"halo={halo} rows x W={w} u8, 2 images, 2 ppermute dirs",
    )
    halo2 = sad_radius + median_radius  # config-2 chain (LR + median)
    add(
        "space_bm_config2", "NVLink", link_bytes_per_s, 2 * 2 * halo2 * w,
        f"chained-window halo={halo2} (SAD+median), see stereo.py:115",
    )

    # Disparity sharding: per-pixel packed-key pmin over the disp axis —
    # a ring all-reduce of an (H_local x W) i32 key array, cost factor
    # 2(p-1)/p of the array per chip (parallel/stereo.py:85,160). NOT a
    # prescribed throughput strategy for config 5 (it is the memory lever
    # for cost volumes that exceed one chip) — kept in the table because
    # the arithmetic shows exactly why: the key all-reduce alone exceeds
    # the per-chip compute at full 1080p.
    key_bytes = h * w * 4
    ar = 2 * (n_chips - 1) / n_chips
    add(
        "disp_wta_allreduce (memory lever, not prescribed)",
        "NVLink", link_bytes_per_s, ar * key_bytes,
        "packed-key pmin ring all-reduce of (H,W) i32 — comm-bound at "
        "full H; only pays when the volume must be split",
    )
    # disp x space combined: key shrinks by the space factor; 2 disp
    # shards x 4 space shards as the example.
    add(
        "disp2_x_space4 (memory lever, not prescribed)",
        "NVLink", link_bytes_per_s,
        (2 * (2 - 1) / 2) * (h // 4) * w * 4 + 2 * 2 * halo * w,
        "2-way WTA all-reduce on a 1/4-height band + band halos",
    )

    # Segment-tree path: independent per-band trees — ZERO cross-chip
    # traffic by construction (parallel/segment_tree.py); the only
    # "efficiency" cost is the quantified accuracy delta (RESULTS.md
    # <=0.42pp at 8 bands) and host-side band-build imbalance.
    add(
        "st_per_band_trees", "none", link_bytes_per_s, 0,
        "independent band trees: no halo, no reduce; accuracy delta "
        "<=0.42pp bad-2.0 at 8 bands is the real cost",
    )

    # Multi-host: data-parallel across hosts (the deployment this
    # framework prescribes) ships nothing per frame; space split across
    # hosts is the worst reasonable case — same halo bytes over the network.
    add(
        "hosts_data_parallel", "network", network_bytes_per_s, 0,
        f"{n_hosts} hosts, frame sharding across the network — no collective",
    )
    add(
        "hosts_space_split", "network", network_bytes_per_s, 2 * 2 * halo * w,
        "pathological layout (band boundary across hosts); still tiny",
    )

    return rows


def print_scaling_prediction(compute_ms_per_frame: float, **kw) -> None:
    rows = predict_scaling_efficiency(compute_ms_per_frame, **kw)
    for r in rows:
        print(json.dumps(r))
    worst_relevant = min(
        r["predicted_efficiency"]
        for r in rows
        if "not prescribed" not in r["strategy"]
    )
    print(json.dumps({
        "metric": "predicted_scaling_efficiency_config5",
        "value": worst_relevant,
        "unit": f"fraction at {kw.get('n_chips', 8)} chips "
                "(worst prescribed strategy, fully-exposed comm)",
        "target": 0.85,
        "pass": bool(worst_relevant >= 0.85),
    }))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--compute-ms", type=float,
                    help="measured fused-kernel ms/frame at 1080p/64d")
    ap.add_argument("--device-kind", default="NVIDIA H100 80GB HBM3")
    ap.add_argument("--live", action="store_true",
                    help="measure the compute time on this GPU first")
    ap.add_argument("--measure", action="store_true",
                    help="also run the mesh sweep over all devices")
    args = ap.parse_args()
    if args.live:
        import bench

        args.compute_ms = 1000.0 / bench.main()
        args.device_kind = jax.devices()[0].device_kind
    if args.compute_ms is None:
        ap.error("pass --compute-ms or --live")
    print_scaling_prediction(args.compute_ms, device_kind=args.device_kind)
    if args.measure:
        run_scaling_benchmark(MeshConfig(data=len(jax.devices()), space=1, disp=1))
