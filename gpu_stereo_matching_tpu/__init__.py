"""gpu_stereo_matching_tpu — a dense stereo depth engine for NVIDIA GPUs.

A from-scratch JAX / XLA / Pallas / pjit framework with the capabilities of the
reference CUDA/C++ project ``ningw42/GPU_Stereo_Matching``:

* **Block matching pipeline** — grayscale conversion, calibration-based
  rectification (bilinear remap), per-disparity absolute-difference cost
  volume, SAD box-filter aggregation, winner-take-all disparity selection
  (reference: ``BlockMatching/Device.cu``).
* **Segment-tree pipeline** — color+gradient matching cost, non-local cost
  aggregation over a spanning tree of the 4-connected image graph built via
  Felzenszwalb–Huttenlocher segmentation, WTA, constant-time median
  post-filter, and an optional second iteration with left-right consistency
  and joint color+depth re-segmentation (reference: ``STMatching/``).

Design is data-parallel, not a port: cost volumes live in ``(D, H, W)`` /
``(B, D, H, W)`` layouts, aggregation uses prefix-sum box filters instead of
per-pixel window loops, the hot path is a fused Pallas (Triton) kernel that
never writes a cost volume, the segment-tree filter is reformulated as
parallel tree scans, and scaling is expressed with ``jax.sharding.Mesh`` +
``shard_map`` halo exchange instead of CUDA grids.
"""

import os as _os

# The segment-tree programs hold about two thousand fused kernels, and their
# GPU compile takes minutes when XLA generates the kernels one after another.
# XLA reads this flag when JAX starts its GPU backend, so importing the
# package before the first computation is enough; a value already in
# XLA_FLAGS wins.
_PARALLEL_GPU_CODEGEN = "--xla_gpu_enable_llvm_module_compilation_parallelism"
_flags = _os.environ.get("XLA_FLAGS", "")
if _PARALLEL_GPU_CODEGEN not in _flags:
    _os.environ["XLA_FLAGS"] = f"{_flags} {_PARALLEL_GPU_CODEGEN}=true".strip()

__version__ = "0.1.0"

from gpu_stereo_matching_tpu.core.config import (  # noqa: F401
    BlockMatchingConfig,
    SegmentTreeConfig,
    MeshConfig,
)
