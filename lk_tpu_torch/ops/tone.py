"""Contrast/brightness tone curve: counterpart of ``lk_tpu.ops.tone``.

``img' = clip((img - 127.5*(1-B)) * k + 127.5*(1+B), 0, 255)`` with
``k = tan((45 + 44c)/180*pi)``, brightness/contrast in -255..255 units
(reference LK3_classification.py:225-241), in that operation order.
"""

from __future__ import annotations

import math

import torch


def tone_constants(brightness: float = 0.0, contrast: float = 100.0):
    """(k, b0, b1) of ``(x - b0) * k + b1``."""
    b = brightness / 255.0
    c = contrast / 255.0
    k = math.tan((45.0 + 44.0 * c) / 180.0 * math.pi)
    return k, 127.5 * (1.0 - b), 127.5 * (1.0 + b)


def contrast_brightness(img: torch.Tensor, brightness: float = 0.0,
                        contrast: float = 100.0) -> torch.Tensor:
    k, b0, b1 = tone_constants(brightness, contrast)
    out = (img.to(torch.float32) - b0) * k + b1
    return out.clamp(0.0, 255.0)
