"""lk_tpu_torch — the PyTorch/CUDA port of ``lk_tpu`` for NVIDIA Hopper.

A second package beside ``lk_tpu`` (the JAX reference it is held against).
It imports ``torch`` and never ``jax``; the configs are ``lk_tpu.config``'s
frozen dataclasses, re-exported here.

Subpackages
-----------
ops        image primitives of the dense path (pyr_down, upsample2_linear)
flow       dense pyramidal LK and its fused level (CUDA kernel + plain torch)
csrc       CUDA sources, built with nvcc at first use (_build.py)
"""

from lk_tpu.config import DenseLKConfig, LKConfig  # noqa: F401
from lk_tpu_torch.flow.dense import (  # noqa: F401
    DenseFlowResult,
    dense_pyramidal_lk,
    dense_pyramidal_lk_multistream,
    dense_pyramidal_lk_video,
)
