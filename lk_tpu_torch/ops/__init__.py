"""Image primitives of the dense path (PyTorch)."""

from lk_tpu_torch.ops.blur import pyr_down  # noqa: F401
from lk_tpu_torch.ops.resize import upsample2_linear  # noqa: F401
