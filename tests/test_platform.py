"""What the program decides from the platform and the environment: which
block-matching path a lowering takes, where compiled code is cached, the
device peak table, the imports the engine needs, the seeded scenes and
the GPU smoke run's result line."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.models.block_matching import (
    block_matching_pipeline,
    sad_wta_disparity,
    sad_wta_keys,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _selector(l, r):
    return sad_wta_disparity(l, r, 16, 2)


def _keys_selector(l, r):
    return sad_wta_keys(l, r, 0, 16, 16, 2)


@pytest.mark.parametrize("selector", [_selector, _keys_selector])
def test_selector_lowers_to_kernel_for_cuda(selector):
    x = jax.ShapeDtypeStruct((2, 40, 96), jnp.uint8)
    text = jax.jit(selector).trace(x, x).lower(lowering_platforms=("cuda",)).as_text()
    assert "sad_wta" in text


def test_selector_runs_xla_path_on_cpu(rng):
    left = rng.integers(0, 256, (2, 40, 96), dtype=np.uint8)
    right = rng.integers(0, 256, (2, 40, 96), dtype=np.uint8)
    text = jax.jit(_selector).lower(left, right).as_text()
    assert "sad_wta" not in text
    got = np.asarray(jax.jit(_selector)(left, right))
    want = np.asarray(
        block_matching_pipeline(
            jnp.asarray(left), jnp.asarray(right),
            BlockMatchingConfig(num_disparities=16, sad_radius=2),
        )
    )
    np.testing.assert_array_equal(got, want)


def _cache_dir_in_child(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    code = (
        "import jax\n"
        "from gpu_stereo_matching_tpu.utils.cache import enable_jit_cache\n"
        "enable_jit_cache()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        check=True, timeout=120,
    )
    return out.stdout.strip().splitlines()[-1]


def test_jit_cache_follows_env_var(tmp_path):
    assert _cache_dir_in_child(str(tmp_path)) == str(tmp_path)


def test_jit_cache_defaults_inside_checkout():
    assert _cache_dir_in_child(None) == os.path.join(REPO, ".jax_cache")


def test_peak_table_known_kind():
    from gpu_stereo_matching_tpu.bench.roofline import device_peaks, fused_sad_roofline

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    row = fused_sad_roofline(1080, 1920, 64, 5, 1.0, "NVIDIA H100 80GB HBM3")
    assert row["bound"] == "int32 issue"
    assert 0 < row["roofline_share"] < 1


def test_peak_table_unknown_kind_raises():
    from gpu_stereo_matching_tpu.bench.roofline import device_peaks

    with pytest.raises(KeyError, match="no peak rates"):
        device_peaks("TFRT_CPU")


def test_engine_imports_without_pil_and_yaml():
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import gpu_stereo_matching_tpu.models.streaming\n"
        "import gpu_stereo_matching_tpu.models.segment_tree_stream\n"
        "import gpu_stereo_matching_tpu.parallel.stereo\n"
        "import gpu_stereo_matching_tpu.parallel.segment_tree\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_synthetic_scene_deterministic():
    from gpu_stereo_matching_tpu.io.synthetic import make_stereo_scene

    a = make_stereo_scene(7, 40, 64, 16, channels=3)
    b = make_stereo_scene(7, 40, 64, 16, channels=3)
    c = make_stereo_scene(8, 40, 64, 16, channels=3)
    for f in ("left", "right", "disparity", "valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.left, c.left)


def test_synthetic_scene_shapes_and_ground_truth():
    from gpu_stereo_matching_tpu.io.synthetic import bad_pixel_rate, make_stereo_scene

    s = make_stereo_scene(3, 48, 80, 12)
    assert s.left.shape == s.right.shape == (48, 80)
    assert s.left.dtype == s.right.dtype == np.uint8
    assert s.disparity.shape == s.valid.shape == (48, 80)
    assert 0 <= s.disparity.min() and s.disparity.max() < 12
    assert 0.5 < s.valid.mean() < 1.0  # occlusion bands exist
    # Every visible left pixel appears in the right image at x - d.
    ys, xs = np.nonzero(s.valid)
    np.testing.assert_array_equal(
        s.right[ys, xs - s.disparity[ys, xs]], s.left[ys, xs]
    )
    assert bad_pixel_rate(s.disparity, s) == 0.0


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_result_line_refuses_non_gpu():
    chip_smoke = _chip_smoke()
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    with pytest.raises(RuntimeError):
        chip_smoke.result_line("cpu", "cpu", 1)


def test_sad_wta_keys_other_invalid_cost_stays_on_xla():
    x = jax.ShapeDtypeStruct((2, 40, 96), jnp.uint8)
    fn = jax.jit(lambda l, r: sad_wta_keys(l, r, 0, 16, 16, 2, invalid_cost=200))
    text = fn.trace(x, x).lower(lowering_platforms=("cuda",)).as_text()
    assert "sad_wta" not in text


@pytest.mark.parametrize(
    "preset, want",
    [
        (None, "--xla_gpu_enable_llvm_module_compilation_parallelism=true"),
        (
            "--xla_gpu_enable_llvm_module_compilation_parallelism=false",
            "--xla_gpu_enable_llvm_module_compilation_parallelism=false",
        ),
    ],
)
def test_package_import_sets_parallel_gpu_codegen(preset, want):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    if preset is not None:
        env["XLA_FLAGS"] = preset
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    code = (
        "import os, gpu_stereo_matching_tpu\n"
        "print(os.environ['XLA_FLAGS'])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        check=True, timeout=120,
    )
    assert out.stdout.strip() == want


def test_sad_roofline_counts_the_shipped_tile():
    from gpu_stereo_matching_tpu.bench.roofline import (
        fused_sad_roofline,
        sad_wta_ops_per_pixel_disparity,
    )
    from gpu_stereo_matching_tpu.kernels.sad_wta import TILES

    kind = "NVIDIA H100 80GB HBM3"
    default = fused_sad_roofline(1080, 1920, 64, 5, 1.0, kind)
    explicit = fused_sad_roofline(1080, 1920, 64, 5, 1.0, kind, TILES["block_w"])
    assert default == explicit
    # r=5: 16-wide left-of-strip window; at block_w=16 two extra AD costs.
    assert sad_wta_ops_per_pixel_disparity(5, 16) == 6 * 10 + 4 + 2 + 8 + 5
    assert sad_wta_ops_per_pixel_disparity(5, 64) < sad_wta_ops_per_pixel_disparity(5, 16)


def test_chip_smoke_counts_executables_until_steady():
    chip_smoke = _chip_smoke()
    executables = chip_smoke.Executables()
    shapes = iter([(3,), (4,), (4,), (4,)])
    fn = jax.jit(lambda x: x * 2 + 1)

    calls = chip_smoke.until_steady(
        "test", executables, lambda: fn(jnp.ones(next(shapes))).block_until_ready()
    )
    assert calls == 3  # two shapes compile, the third call builds nothing
    with pytest.raises(AssertionError, match="still compiling"):
        chip_smoke.until_steady(
            "test", executables,
            lambda: jax.jit(lambda x: x - 1)(jnp.ones(2)).block_until_ready(),
            limit=2,
        )
