"""Image primitives (PyTorch): counterpart of ``lk_tpu.ops``, with its
exports.  The pyramid (``pyr_down``, ``gaussian_pyramid``) runs the CUDA
pyramid kernel on card tensors, built at its first launch, not here."""

from lk_tpu_torch.ops.color import bgr_to_gray, bgr_to_gray_u8  # noqa: F401
from lk_tpu_torch.ops.blur import (  # noqa: F401
    gaussian_blur3,
    gaussian_pyramid,
    pyr_down,
)
from lk_tpu_torch.ops.resize import (  # noqa: F401
    area_weights,
    resize_area,
    resize_linear,
    upsample2_linear,
)
from lk_tpu_torch.ops.gradients import (  # noqa: F401
    scharr_derivatives,
    sobel_derivatives,
)
from lk_tpu_torch.ops.warp import (  # noqa: F401
    bilinear_sample,
    extract_patch,
    warp_by_flow,
)
from lk_tpu_torch.ops.rasterize import (  # noqa: F401
    fill_convex_poly,
    masks_from_points,
)
from lk_tpu_torch.ops.boxfilter import box_sum  # noqa: F401
from lk_tpu_torch.ops.tone import contrast_brightness  # noqa: F401
