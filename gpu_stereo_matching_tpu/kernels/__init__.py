from gpu_stereo_matching_tpu.kernels.sad_wta import (  # noqa: F401
    fused_block_matching,
    fused_block_matching_key,
)
