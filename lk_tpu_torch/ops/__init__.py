"""Image primitives (PyTorch)."""

from lk_tpu_torch.ops.blur import gaussian_blur3, pyr_down  # noqa: F401
from lk_tpu_torch.ops.resize import (resize_area,  # noqa: F401
                                     upsample2_linear)
