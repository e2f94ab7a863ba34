"""Color conversion: counterpart of ``lk_tpu.ops.color``.

OpenCV 5.x computes gray with shift-15 fixed-point coefficients:
y = (9798*R + 19235*G + 3735*B + 2^14) >> 15.  The float path uses the same
Rec.601 weights.
"""

from __future__ import annotations

import torch

_R, _G, _B = 9798, 19235, 3735  # shift-15 fixed point (sum = 32768)
_SHIFT = 15


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """BGR (..., H, W, 3) in 0..255 -> gray (..., H, W) float32, unrounded."""
    b = bgr[..., 0].to(torch.float32)
    g = bgr[..., 1].to(torch.float32)
    r = bgr[..., 2].to(torch.float32)
    return r * 0.299 + g * 0.587 + b * 0.114


def bgr_to_gray_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Bit-exact uint8 path matching cv2 5.0's fixed-point BGR2GRAY."""
    b = bgr_u8[..., 0].to(torch.int32)
    g = bgr_u8[..., 1].to(torch.int32)
    r = bgr_u8[..., 2].to(torch.int32)
    y = (r * _R + g * _G + b * _B + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.uint8)
