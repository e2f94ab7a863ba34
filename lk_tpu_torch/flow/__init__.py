"""The LK core (PyTorch): the per-point sparse tracker and dense pyramidal
LK with its fused levels; counterpart of ``lk_tpu.flow``, with its
exports."""

from lk_tpu_torch.flow.sparse import (  # noqa: F401
    build_tracking_pyramid,
    track_points,
)
from lk_tpu_torch.flow.dense import (  # noqa: F401
    dense_lk_level,
    dense_pyramidal_lk,
    dense_pyramidal_lk_batched,
    dense_pyramidal_lk_multistream,
    dense_pyramidal_lk_video,
)
