#!/usr/bin/env python3
"""Run both stereo pipelines once on one GPU at real sizes, and check them.

Usage (from the root of the repository, on a machine with an NVIDIA GPU):

    python chip_smoke.py [--seed N]          # six phases on one card
    python chip_smoke.py --multi [--seed N]  # the sharded paths on four cards

Phases on one card (inputs are seeded synthetic scenes with ground truth,
``io/synthetic.py``; CPU comparisons run in this same process on
``jax.devices("cpu")[0]``):

1. device: the platform must be ``gpu``; prints the card, the device kind
   and count, and the host's CPU count (the ST host build scales with it);
2. block matching 1080×1920, 64 levels, r=5, batch 8: the main path
   (``sad_wta_disparity``, the fused kernel on the GPU) against
   ``block_matching_pipeline`` (plain XLA), one frame of it on the CPU, and
   the NumPy oracle on a 128×256 crop — all bit-identical;
3. the same with LR check and a radius-5 median, against the CPU;
4. a calibrated ``StereoRig`` at 720×1280: rectified images within one gray
   level of the CPU, disparities bit-identical to the XLA path on them;
5. streaming ST-1 (370×463, 60 levels, 3 groups of 8) against
   ``st1_disparity`` on the CPU: at most 1% of pixels off by more than one
   level (f32 tree sums run in another order; WTA ties flip);
6. streaming ST-2, 2 groups, with the same tolerance against
   ``st2_disparity``.

The ST streams are warmed up on their first group until a pass compiles
nothing; the timed pass must build no executable.

``--multi`` runs instead, on four cards: sharded block matching on two
meshes and the sharded LR + median chain, each bit-identical to one card;
then sharded ST-1 and ST-2 over ``space=4`` against the tiled pipelines
(4 bands) on the CPU, with the ST tolerance.

Every phase raises on failure. The last line of standard output is the JSON
result; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ST_TOLERANCE = 0.01  # share of pixels allowed off by more than one level
# (batch, height, width, levels, SAD radius) of the block-matching phases.
BM_SHAPE = (8, 1080, 1920, 64, 5)
RIG_SHAPE = (8, 720, 1280, 64, 5)
# (height, width, levels) of the ST phases: Middlebury third-size.
ST_SHAPE = (370, 463, 60)
CROP = (128, 256)  # oracle crop of the headline phase


def result_line(platform: str, kind: str, count: int) -> str:
    """The final JSON line; refuses any platform but ``gpu``."""
    if platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {platform!r}")
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def log(phase: str, **fields) -> None:
    items = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {items}", flush=True)


def timed(fn):
    """(result, seconds) of ``fn()`` run to completion on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def run_twice(fn):
    """First call (compile + run) and second call (run) times."""
    out, first = timed(fn)
    out, second = timed(fn)
    return out, first, second


class Executables:
    """Counts the XLA executables JAX builds, compiled or loaded from the
    persistent compile cache, and the seconds that takes (jax.monitoring)."""

    def __init__(self):
        from jax import monitoring

        self.built = self.from_cache = 0
        self.seconds = 0.0
        monitoring.register_event_duration_secs_listener(self._duration)
        monitoring.register_event_listener(self._event)

    def _duration(self, event, duration_secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.built += 1
            self.seconds += duration_secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.from_cache += 1

    def state(self):
        return self.built, self.from_cache, self.seconds

    def since(self, state) -> dict:
        built, from_cache, seconds = state
        return dict(
            executables_built=self.built - built,
            from_compile_cache=self.from_cache - from_cache,
            build_s=self.seconds - seconds,
        )


def until_steady(phase: str, executables: Executables, run, limit: int = 3):
    """Call ``run`` until a call builds no executable; return the calls made.

    The segment-tree plan layouts come from a registry that grows while it
    sees new trees, and a grown layout is a new program. ST-2 feeds the
    registry two tree families (the σ₁ view trees and the re-segmentation
    trees), so its second call compiles phase 1 again for the layout the
    re-segmentation trees grew (PERF.md, Open questions).
    """
    for calls in range(1, limit + 1):
        before = executables.built
        run()
        if executables.built == before:
            return calls
    raise AssertionError(f"{phase}: still compiling after {limit} warm-up calls")


def assert_equal(phase: str, what: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{phase}: {what}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    log(phase, check=what, differing_pixels=bad, of=got.size)
    if bad:
        raise AssertionError(f"{phase}: {what}: {bad} pixels differ")


def check_st(phase: str, what: str, pairs, scale: int) -> None:
    """ST outputs (scaled u8) against their references, frame by frame."""
    off, same = [], []
    for got, want in pairs:
        diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
        off.append(float((diff > scale).mean()))
        same.append(float((diff == 0).mean()))
    log(phase, check=what, frames=len(off),
        worst_share_off_by_more_than_one_level=max(off),
        least_share_identical=min(same), limit=ST_TOLERANCE)
    if max(off) > ST_TOLERANCE:
        raise AssertionError(f"{phase}: {what}: {max(off):.4%} of pixels off")


def scenes(seed, n, h, w, num_d, channels):
    from gpu_stereo_matching_tpu.io.synthetic import make_stereo_scene

    return [make_stereo_scene(seed + i, h, w, num_d, channels) for i in range(n)]


def phase_device():
    import jax

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    log("device", platform=dev.platform, kind=repr(dev.device_kind),
        count=len(jax.devices()), host_cpus=os.cpu_count(), jax=jax.__version__,
        xla_flags=repr(os.environ.get("XLA_FLAGS", "")))
    return dev


def phase_bm_headline(seed, cpu):
    import jax
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.io.synthetic import bad_pixel_rate
    from gpu_stereo_matching_tpu.models.block_matching import (
        block_matching_pipeline,
        sad_wta_disparity,
    )
    from tests import oracles

    phase = "bm_1080p"
    b, h, w, num_d, r = BM_SHAPE
    sc = scenes(seed, b, h, w, num_d, 1)
    left = jnp.asarray(np.stack([s.left for s in sc]))
    right = jnp.asarray(np.stack([s.right for s in sc]))
    main = jax.jit(lambda l, rr: sad_wta_disparity(l, rr, num_d, r))
    if "sad_wta" not in main.lower(left, right).as_text():
        raise AssertionError(f"{phase}: the GPU lowering does not use the kernel")
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=r)

    disp, k_first, k_run = run_twice(lambda: main(left, right))
    ref, x_first, x_run = run_twice(lambda: block_matching_pipeline(left, right, cfg))
    log(phase, path="fused_kernel", compile_and_run_s=k_first, run_s=k_run,
        ms_per_frame=k_run / b * 1e3)
    log(phase, path="xla_pipeline", compile_and_run_s=x_first, run_s=x_run,
        ms_per_frame=x_run / b * 1e3)
    assert_equal(phase, "kernel vs block_matching_pipeline", disp, ref)

    with jax.default_device(cpu):
        cpu_disp, c_s = timed(lambda: main(np.asarray(left[0]), np.asarray(right[0])))
    log(phase, path="cpu_one_frame", compile_and_run_s=c_s)
    assert_equal(phase, "frame 0 vs CPU backend", disp[0], cpu_disp)

    lc, rc = sc[0].left[: CROP[0], : CROP[1]], sc[0].right[: CROP[0], : CROP[1]]
    crop = np.asarray(main(jnp.asarray(lc), jnp.asarray(rc)))
    want = oracles.wta_oracle(
        oracles.box_sum_oracle(oracles.ad_cost_volume_oracle(lc, rc, num_d), r)
    )
    assert_equal(phase, "128x256 crop vs NumPy oracle", crop, want)
    bad2 = np.mean([bad_pixel_rate(np.asarray(disp[i]), sc[i]) for i in range(b)])
    log(phase, bad2=bad2)


def phase_bm_config2(seed, cpu):
    import jax
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.io.synthetic import bad_pixel_rate
    from gpu_stereo_matching_tpu.models.block_matching import block_matching_pipeline
    from gpu_stereo_matching_tpu.ops.postprocess import median_filter_u8

    phase = "bm_1080p_lr_median5"
    b, h, w, num_d, r = BM_SHAPE
    sc = scenes(seed + 100, b, h, w, num_d, 1)
    left = jnp.asarray(np.stack([s.left for s in sc]))
    right = jnp.asarray(np.stack([s.right for s in sc]))
    cfg = BlockMatchingConfig(
        num_disparities=num_d, sad_radius=r, lr_consistency=True, median_radius=5
    )
    disp, first, run = run_twice(lambda: block_matching_pipeline(left, right, cfg))
    log(phase, compile_and_run_s=first, run_s=run, ms_per_frame=run / b * 1e3)
    with jax.default_device(cpu):
        cpu_disp, c_s = timed(
            lambda: block_matching_pipeline(
                np.asarray(left[:1]), np.asarray(right[:1]), cfg
            )
        )
    log(phase, path="cpu_one_frame", compile_and_run_s=c_s)
    assert_equal(phase, "frame 0 vs CPU backend", disp[:1], cpu_disp)
    med = jax.jit(lambda d: median_filter_u8(d, 5))
    d8 = disp.astype(jnp.uint8)
    _, m_first, m_run = run_twice(lambda: med(d8))
    log(phase, path="median_r5_histogram", compile_and_run_s=m_first,
        run_s=m_run, ms_per_frame=m_run / b * 1e3)
    # LR-rejected pixels read 0; bad-2.0 counts them as errors.
    bad2 = np.mean([bad_pixel_rate(np.asarray(disp[i]), sc[i]) for i in range(b)])
    log(phase, bad2=bad2)


def seeded_calibration(seed, h, w):
    from gpu_stereo_matching_tpu.io.calib_yaml import StereoCalibration

    rng = np.random.default_rng(seed)
    f = 0.8 * w
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    k2 = k * np.array([[1 + rng.uniform(-0.01, 0.01)], [1 + rng.uniform(-0.01, 0.01)], [1]])
    return StereoCalibration(
        left_intrinsics=k,
        right_intrinsics=k2,
        left_distortion=np.array([rng.uniform(-0.05, 0.05), 0.0, 0.0, 0.0, 0.0]),
        right_distortion=np.array([rng.uniform(-0.05, 0.05), 0.0, 0.0, 0.0, 0.0]),
        rotation=np.eye(3),
        translation=np.array([-60.0, rng.uniform(-0.5, 0.5), 0.0]),
    )


def phase_rig(seed, cpu):
    import tempfile

    import jax

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.io.synthetic import bad_pixel_rate
    from gpu_stereo_matching_tpu.models.block_matching import (
        block_matching_pipeline,
        sad_wta_disparity,
    )
    from gpu_stereo_matching_tpu.models.streaming import StereoRig
    from gpu_stereo_matching_tpu.utils.cache import ArtifactCache

    phase = "rig_720p"
    b, h, w, num_d, r = RIG_SHAPE
    sc = scenes(seed + 200, b, h, w, num_d, 3)
    lb = np.stack([s.left for s in sc])
    rb = np.stack([s.right for s in sc])
    calib = seeded_calibration(seed, h, w)
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=r)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rig = StereoRig(calib, (h, w), cfg, cache=ArtifactCache(tmp))
        log(phase, maps_s=time.perf_counter() - t0)
        disp, first, run = run_twice(lambda: rig.process_batch(lb, rb))
        log(phase, compile_and_run_s=first, run_s=run, ms_per_frame=run / b * 1e3)
        rect_l, rect_r = rig.rectify_batch(lb, rb)
        with jax.default_device(cpu):
            rig_cpu = StereoRig(calib, (h, w), cfg, cache=ArtifactCache(tmp))
            cpu_l, cpu_r = rig_cpu.rectify_batch(lb, rb)
    for name, got, want in (("left", rect_l, cpu_l), ("right", rect_r, cpu_r)):
        diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
        log(phase, check=f"rectified {name} vs CPU", max_abs_diff=int(diff.max()),
            share_differing=float((diff > 0).mean()), limit=1)
        if diff.max() > 1:
            raise AssertionError(f"{phase}: rectified {name} off by {diff.max()}")
    main = jax.jit(lambda l, rr: sad_wta_disparity(l, rr, num_d, r))
    kdisp, k_first, k_run = run_twice(lambda: main(rect_l, rect_r))
    ref, x_first, x_run = run_twice(
        lambda: block_matching_pipeline(rect_l, rect_r, cfg)
    )
    _, rect_run = timed(lambda: rig.rectify_batch(lb, rb))
    log(phase, path="fused_kernel", run_s=k_run, ms_per_frame=k_run / b * 1e3)
    log(phase, path="xla_pipeline", run_s=x_run, ms_per_frame=x_run / b * 1e3)
    log(phase, path="rectify_gray_remap_both_views", run_s=rect_run,
        ms_per_frame=rect_run / b * 1e3)
    assert_equal(phase, "disparity vs XLA path on the rectified pair", disp, ref)
    assert_equal(phase, "kernel vs XLA path on the rectified pair", kdisp, ref)
    # Ground truth is in scene coordinates; rectification moves pixels a
    # little, so this rate is a sanity figure, not an accuracy claim.
    bad2 = np.mean([bad_pixel_rate(np.asarray(disp[i]), sc[i]) for i in range(b)])
    log(phase, bad2_scene_coordinates=bad2)


def _st_frames(seed, n_unique, n_frames):
    h, w, num_d = ST_SHAPE
    sc = scenes(seed, n_unique, h, w, num_d, 3)
    return sc, [(sc[i % n_unique].left, sc[i % n_unique].right) for i in range(n_frames)]


def phase_st(seed, cpu, iterate, executables):
    import jax

    from gpu_stereo_matching_tpu.core.config import SegmentTreeConfig
    from gpu_stereo_matching_tpu.io.synthetic import bad_pixel_rate
    from gpu_stereo_matching_tpu.models.segment_tree import st1_disparity, st2_disparity
    from gpu_stereo_matching_tpu.models.segment_tree_stream import (
        SegmentTreeBatchPipeline,
        SegmentTreeST2BatchPipeline,
    )

    phase = "st2_stream" if iterate else "st1_stream"
    cfg = SegmentTreeConfig(max_disp_levels=ST_SHAPE[2])
    groups, g, n_unique = (2 if iterate else 3), 8, 4
    sc, frames = _st_frames(seed + (400 if iterate else 300), n_unique, groups * g)
    pipe = (SegmentTreeST2BatchPipeline if iterate else SegmentTreeBatchPipeline)(
        cfg, group_size=g
    )
    # Warm-up passes over the first group compile; the timed pass over all
    # groups is the steady-state stream and must build nothing.
    state = executables.state()
    t0 = time.perf_counter()
    passes = until_steady(phase, executables, lambda: list(pipe.process(frames[:g])))
    log(phase, warmup_passes=passes, warmup_s=time.perf_counter() - t0,
        **executables.since(state))
    state = executables.state()
    t0 = time.perf_counter()
    outs = list(pipe.process(frames))
    run = time.perf_counter() - t0
    if executables.state() != state:
        raise AssertionError(f"{phase}: the timed pass built executables")
    log(phase, groups=groups, group_size=g, run_s=run,
        ms_per_frame=run / len(frames) * 1e3)
    ref_fn = st2_disparity if iterate else st1_disparity
    with jax.default_device(cpu):
        refs, c_s = timed(lambda: [ref_fn(s.left, s.right, cfg) for s in sc])
    log(phase, path="cpu_reference", scenes=n_unique, s=c_s)
    check_st(
        phase, "frames vs CPU",
        [(out, refs[i % n_unique]) for i, out in enumerate(outs)],
        cfg.disparity_scale,
    )
    bad2 = np.mean([
        bad_pixel_rate(outs[i] / cfg.disparity_scale, sc[i]) for i in range(n_unique)
    ])
    log(phase, bad2=bad2)


def run_phases(phases, executables) -> None:
    for name, fn in phases:
        state = executables.state()
        t0 = time.perf_counter()
        fn()
        log(name, phase_wall_s=time.perf_counter() - t0,
            **executables.since(state), status="passed")


def run_single(seed, executables):
    import jax

    from gpu_stereo_matching_tpu.tree import builder

    dev = phase_device()
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    builder._lib()
    log("device", tree_library_build_s=time.perf_counter() - t0)
    run_phases((
        ("bm_1080p", lambda: phase_bm_headline(seed, cpu)),
        ("bm_1080p_lr_median5", lambda: phase_bm_config2(seed, cpu)),
        ("rig_720p", lambda: phase_rig(seed, cpu)),
        ("st1_stream", lambda: phase_st(seed, cpu, False, executables)),
        ("st2_stream", lambda: phase_st(seed, cpu, True, executables)),
    ), executables)
    return dev


def run_multi(seed, executables):
    """The sharded paths on a four-card mesh, each against its one-device
    counterpart."""
    import jax

    dev = phase_device()
    if len(jax.devices()) != 4:
        raise RuntimeError(f"--multi needs 4 GPUs, found {len(jax.devices())}")
    run_phases((
        ("multi_bm", lambda: multi_bm(seed)),
        ("multi_st", lambda: multi_st(seed, executables)),
    ), executables)
    return dev


def multi_bm(seed):
    """Sharded block matching (two meshes, and the config-2 chain)."""
    import jax
    import jax.numpy as jnp

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig, MeshConfig
    from gpu_stereo_matching_tpu.models.block_matching import (
        block_matching_pipeline,
        sad_wta_disparity,
    )
    from gpu_stereo_matching_tpu.parallel.mesh import build_mesh
    from gpu_stereo_matching_tpu.parallel.stereo import (
        make_sharded_block_matching,
        make_sharded_block_matching_full,
        shard_batch,
    )

    b, h, w, num_d, r = BM_SHAPE
    sc = scenes(seed, b, h, w, num_d, 1)
    left = np.stack([s.left for s in sc])
    right = np.stack([s.right for s in sc])
    cfg = BlockMatchingConfig(num_disparities=num_d, sad_radius=r)
    one = jax.devices()[0]
    single = jax.block_until_ready(
        jax.jit(lambda l, rr: sad_wta_disparity(l, rr, num_d, r))(
            jax.device_put(left, one), jax.device_put(right, one)
        )
    )
    for shape in ((2, 2, 1), (1, 2, 2)):
        phase = f"sharded_bm_{'x'.join(map(str, shape))}"
        mesh = build_mesh(MeshConfig(*shape))
        step = make_sharded_block_matching(mesh, cfg)
        jl, jr = shard_batch(mesh, jnp.asarray(left), jnp.asarray(right))
        got, first, run = run_twice(lambda: step(jl, jr))
        log(phase, compile_and_run_s=first, run_s=run, ms_per_frame=run / b * 1e3)
        assert_equal(phase, "vs one card", got, single)

    phase = "sharded_bm_full_2x2x1"
    cfg2 = BlockMatchingConfig(
        num_disparities=num_d, sad_radius=r, lr_consistency=True, median_radius=5
    )
    mesh = build_mesh(MeshConfig(2, 2, 1))
    step = make_sharded_block_matching_full(mesh, cfg2)
    jl, jr = shard_batch(mesh, jnp.asarray(left), jnp.asarray(right))
    got, first, run = run_twice(lambda: step(jl, jr))
    log(phase, compile_and_run_s=first, run_s=run, ms_per_frame=run / b * 1e3)
    want = block_matching_pipeline(
        jax.device_put(left, one), jax.device_put(right, one), cfg2
    )
    assert_equal(phase, "vs one card", got, want)


def multi_st(seed, executables):
    """Sharded ST-1 and ST-2 over ``space=4`` against the tiled pipelines."""
    import jax

    from gpu_stereo_matching_tpu.core.config import MeshConfig, SegmentTreeConfig
    from gpu_stereo_matching_tpu.models.segment_tree_tiled import (
        st1_disparity_tiled,
        st2_disparity_tiled,
    )
    from gpu_stereo_matching_tpu.parallel.mesh import build_mesh
    from gpu_stereo_matching_tpu.parallel.segment_tree import (
        st1_disparity_sharded,
        st2_disparity_sharded,
    )

    st_h, st_w, st_d = ST_SHAPE
    st_cfg = SegmentTreeConfig(max_disp_levels=st_d)
    st_mesh = build_mesh(MeshConfig(1, 4, 1))
    # Rows cut to a multiple of 4 (370 → 368) for four equal bands.
    s = scenes(seed + 500, 1, st_h - st_h % 4, st_w, st_d, 3)[0]
    # The tiled references run first, on the host CPU: they build every
    # band's trees, so the layout registry already holds the layouts of the
    # sharded runs, whose GPU programs are then compiled once.
    cases = (
        ("sharded_st1_space4", st1_disparity_sharded, st1_disparity_tiled),
        ("sharded_st2_space4", st2_disparity_sharded, st2_disparity_tiled),
    )
    refs = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for name, _, tiled in cases:
            refs[name], c_s = timed(lambda: tiled(s.left, s.right, 4, st_cfg))
            log(name, path="tiled_cpu_reference", s=c_s)
    for name, sharded, _ in cases:
        state = executables.state()
        t0 = time.perf_counter()
        calls = until_steady(
            name, executables, lambda: sharded(s.left, s.right, st_mesh, st_cfg)
        )
        log(name, warmup_calls=calls, warmup_s=time.perf_counter() - t0,
            **executables.since(state))
        state = executables.state()
        got, run = timed(lambda: sharded(s.left, s.right, st_mesh, st_cfg))
        if executables.state() != state:
            raise AssertionError(f"{name}: the timed call built executables")
        log(name, run_s=run)
        check_st(name, "vs tiled (4 bands) on the CPU", [(got, refs[name])],
                 st_cfg.disparity_scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run the sharded paths on four cards instead")
    args = ap.parse_args(argv)

    # The package sets its XLA flags on import, before JAX starts a backend.
    from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    enable_jit_cache()
    executables = Executables()
    t0 = time.perf_counter()
    run = run_multi if args.multi else run_single
    dev = run(args.seed, executables)
    log("total", wall_s=time.perf_counter() - t0)
    print(result_line(dev.platform, dev.device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
