"""Multi-host launch glue.

There is no hand-written transport (the reference has none either — its
only parallelism is single-GPU SIMT): multi-host runs use JAX's built-in
distributed runtime; XLA hands every collective in the sharded pipeline
(halo ``ppermute``, WTA ``pmin``) to NCCL, over NVLink within a host and
the network across hosts.

Typical SPMD launch — the same script on every host, one process per host:

    python -m gpu_stereo_matching_tpu.parallel.launch \
        --coordinator 10.0.0.1:8476 --num-processes 4 --process-id $ID

On a single host, run it with no arguments: all local cards form the mesh.
"""

from __future__ import annotations

import argparse
from typing import Optional


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX distributed runtime for a multi-host run.

    Nothing tells JAX of a GPU cluster, so all three arguments are needed;
    with no coordinator this is a single-host run and does nothing.
    """
    import jax

    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--data", type=int, default=None, help="mesh data axis (default: all devices)")
    p.add_argument("--space", type=int, default=1)
    p.add_argument("--disp", type=int, default=1)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    args = p.parse_args(argv)

    initialize_distributed(args.coordinator, args.num_processes, args.process_id)

    import jax

    from gpu_stereo_matching_tpu.bench.scaling import run_scaling_benchmark
    from gpu_stereo_matching_tpu.core.config import MeshConfig

    n_dev = len(jax.devices())
    data = args.data or n_dev // (args.space * args.disp)
    cfg = MeshConfig(data=data, space=args.space, disp=args.disp)
    run_scaling_benchmark(
        cfg, num_frames=args.frames, height=args.height, width=args.width
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
