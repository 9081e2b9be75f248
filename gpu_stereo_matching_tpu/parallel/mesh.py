"""Device-mesh construction for distributed stereo.

The reference's only parallelism is single-GPU CUDA grid/block data
parallelism (SURVEY §2.5); this framework defines its own first-class
strategies over a ``jax.sharding.Mesh`` with axes:

* ``data``  — stereo frame batches (pure DP, no communication),
* ``space`` — image/cost-volume H tiling with ``ppermute`` halo exchange
  (the ring/CP-style neighbor pattern),
* ``disp``  — disparity-axis sharding (TP analog); WTA becomes a packed
  min-argmin reduction over the axis.

The mesh follows the algorithm alone: the cards of one host are joined all
to all by NVLink, so any device order serves every axis equally, and XLA
hands the collectives to NCCL. Multi-host: initialize ``jax.distributed``
outside and pass the global device list; ``data`` is outermost, so with
contiguous per-host device blocks the network between hosts only carries
embarrassingly parallel frame traffic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from gpu_stereo_matching_tpu.core.config import MeshConfig


def build_mesh(
    config: MeshConfig, devices: Optional[Sequence[jax.Device]] = None
) -> Mesh:
    """Build a ``(data, space, disp)`` mesh from the given/available devices.

    ``data`` is the outermost (slowest-varying) axis so that, in multi-host
    runs with contiguous per-host device blocks, halo and WTA collectives
    stay within one host's NVLink domain.
    """
    devs = list(devices) if devices is not None else jax.devices()
    need = config.num_devices
    if len(devs) < need:
        raise ValueError(
            f"mesh {config.shape} needs {need} devices, have {len(devs)}"
        )
    arr = np.array(devs[:need]).reshape(config.shape)
    return Mesh(arr, config.axis_names)


def virtual_cpu_mesh(config: MeshConfig) -> Mesh:
    """Mesh over the virtual CPU devices used by tests / dry runs.

    Requires ``--xla_force_host_platform_device_count=N`` to have been set
    before JAX initialized (see ``tests/conftest.py``).
    """
    return build_mesh(config, jax.devices())
