"""Worker for the real multi-process `jax.distributed` smoke test.

Each of N processes owns 4 virtual CPU devices; together they form an
8-device (space=2, data=2, disp=2) mesh whose *space* axis crosses the
process boundary — so the SAD window's halo `ppermute` and the WTA `pmin`
genuinely traverse the distributed runtime (the path between hosts in a
multi-host deployment).
Every process asserts its addressable output shards are bit-identical to
a single-device run of the same step.

Usage: dist_worker.py <process_id> <num_processes> <coordinator_port>
Spawned by tests/test_distributed.py and usable standalone. Requires
JAX_PLATFORMS=cpu and the repository on PYTHONPATH.
"""

import os
import sys


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    inherited = [
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    os.environ["XLA_FLAGS"] = " ".join(
        ["--xla_force_host_platform_device_count=4"] + inherited
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gpu_stereo_matching_tpu.parallel.launch import (
        initialize_distributed,
    )

    initialize_distributed(f"localhost:{port}", nproc, pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
    from gpu_stereo_matching_tpu.parallel.stereo import (
        make_sharded_block_matching,
    )

    assert len(jax.devices()) == 4 * nproc, jax.devices()
    assert len(jax.local_devices()) == 4

    # space axis outermost -> space shards live on DIFFERENT processes:
    # the halo exchange is a real cross-process collective.
    devs = np.array(jax.devices()).reshape(nproc, 2, 2)
    mesh = Mesh(devs, ("space", "data", "disp"))

    rng = np.random.default_rng(42)
    b, h, w = 4, 64, 128
    left = rng.integers(0, 256, (b, h, w), np.uint8)
    right = rng.integers(0, 256, (b, h, w), np.uint8)

    cfg = BlockMatchingConfig(num_disparities=16, sad_radius=2)
    step = make_sharded_block_matching(mesh, cfg)
    sharding = NamedSharding(mesh, P("data", "space", None))
    gl = jax.make_array_from_callback(left.shape, sharding,
                                      lambda idx: left[idx])
    gr = jax.make_array_from_callback(right.shape, sharding,
                                      lambda idx: right[idx])
    out = step(gl, gr)

    # Single-device reference on one LOCAL device (same step, 1x1x1 mesh).
    ref_mesh = Mesh(
        np.array(jax.local_devices()[:1]).reshape(1, 1, 1),
        ("space", "data", "disp"),
    )
    ref_step = make_sharded_block_matching(ref_mesh, cfg)
    ref = np.asarray(ref_step(jnp.asarray(left), jnp.asarray(right)))

    n_checked = 0
    for shard in out.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      ref[shard.index])
        n_checked += 1
    assert n_checked > 0
    print(f"dist_worker process {pid}/{nproc}: {n_checked} shards "
          "bit-identical to single-device", flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
