"""Spatial derivatives for the LK structure tensor: counterpart of
``lk_tpu.ops.gradients``.

Scharr-style separable derivatives, normalized to intensity-gradient units:
smooth [3,10,3]/16 across, then the central difference [-1,0,1]/2, both
with REFLECT_101 borders and the taps summed in order
(``blur._sep_filter_axis``).  The tracker's window-gather kernel
(``csrc/window_gather.cu``) repeats exactly this operation order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lk_tpu_torch.ops.blur import _sep_filter_axis

SCHARR_SMOOTH = (3 / 16, 10 / 16, 3 / 16)
SOBEL_SMOOTH = (0.25, 0.5, 0.25)
DIFF = (-0.5, 0.0, 0.5)


def _derivatives(img: torch.Tensor, smooth) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    x = img.to(torch.float32)
    ix = _sep_filter_axis(_sep_filter_axis(x, smooth, -2), DIFF, -1)
    iy = _sep_filter_axis(_sep_filter_axis(x, smooth, -1), DIFF, -2)
    return ix, iy


def scharr_derivatives(img: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(Ix, Iy) via normalized Scharr: smooth [3,10,3]/16, diff [-1,0,1]/2."""
    return _derivatives(img, SCHARR_SMOOTH)


def sobel_derivatives(img: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(Ix, Iy) via normalized 3x3 Sobel: smooth [1,2,1]/4, diff [-1,0,1]/2
    (the Shi–Tomasi response's gradients)."""
    return _derivatives(img, SOBEL_SMOOTH)
