"""lk_tpu_torch — the PyTorch/CUDA port of ``lk_tpu`` for NVIDIA Hopper.

A second package beside ``lk_tpu`` (the JAX reference it is held against).
It imports ``torch`` and nothing of ``jax`` or ``lk_tpu``: the configs are
its own copy (``lk_tpu_torch.config``, presets in ``lk_tpu_torch.models``).
Entry points that build their own state or take numpy put it on the card
(``device="cuda"``) unless the caller names another device; functions that
take tensors run where those tensors are.

Subpackages
-----------
ops        image primitives: pyramid, blur, gradients, box sums, resize,
           ROI masks, color, tone, homography, and the serving finish
           (CUDA + plain)
features   Shi–Tomasi corners
flow       dense pyramidal LK (fused level: CUDA + plain), the per-point
           sparse tracker and the batched one (window gather: CUDA + plain)
geometry   flow lines, cross points, the VP state machine, motion classes,
           Hough road-line voting
pipeline   the VP pipeline: state, step, VideoPipeline (one video, with
           checkpoints and prefetch), MultiStreamPipeline (batched
           serving); the LK1/LK2 masked tracker
io         video sources (the synthetic road stream rendered on the
           device), LKRAW and its g++-built native reader, chunk
           prefetchers and the output sinks (vps_<video>.csv)
apps       the five reference apps and the serving benchmark
           (python -m lk_tpu_torch.apps <app>); apps.display the viewer
viz        the reference's figures (matplotlib / OpenCV, imported when
           drawing)
utils      state checkpoints, profiling (``span``: the gated profiler range)
csrc       CUDA sources, built with nvcc at first use (_build.py)
"""

from lk_tpu_torch.config import (  # noqa: F401
    DenseLKConfig,
    FeatureConfig,
    LKConfig,
    PipelineConfig,
    ROIConfig,
)
from lk_tpu_torch.flow.dense import (  # noqa: F401
    DenseFlowResult,
    dense_pyramidal_lk,
    dense_pyramidal_lk_multistream,
    dense_pyramidal_lk_video,
)
from lk_tpu_torch.pipeline.runner import (  # noqa: F401
    MultiStreamPipeline,
    VideoPipeline,
)
