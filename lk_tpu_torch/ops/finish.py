"""The serving ``finish``: u8/f32 frames -> f32, optional tone curve, 3x3
Gaussian.  Kernel wrapper and plain version.

Counterpart of ``lk_tpu/ops/pallas_finish.py`` ``fused_finish`` and of the
XLA chain it replaces (``lk_tpu.pipeline.runner._cached_finish``: convert,
``ops.tone.contrast_brightness``, ``ops.blur.gaussian_blur3``).

``fused_finish`` dispatches on the device of its input: a CPU tensor goes
to ``fused_finish_reference`` (plain PyTorch), a CUDA tensor to the CUDA
kernel ``lk_tpu_torch/csrc/finish.cu``, with no fallback between the two.
Both compute each output as the plain chain does, operation by operation
(the kernel is built without FMA contraction), so they agree bit for bit,
with and without the tone curve.  The Pallas kernel's tone FMA (<= 1 ulp
from the chain) is not reproduced.
"""

from __future__ import annotations

import ctypes

import torch

from lk_tpu_torch.ops.blur import gaussian_blur3
from lk_tpu_torch.ops.tone import contrast_brightness, tone_constants

# Kernel launches of the CUDA finish, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


def _check(x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"finish takes (N, H, W) frames, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"finish takes uint8 or float32, got {x.dtype}")
    if x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"REFLECT_101 needs H, W >= 2: {tuple(x.shape)}")


def fused_finish(x: torch.Tensor, contrast: bool = False) -> torch.Tensor:
    """(N, H, W) u8/f32 frames -> (N, H, W) f32: convert, tone curve when
    ``contrast`` (``contrast_brightness`` defaults), 3x3 Gaussian."""
    if x.device.type == "cpu":
        return fused_finish_reference(x, contrast)
    if x.device.type != "cuda":
        raise ValueError(f"fused_finish: unsupported device {x.device}")
    return _fused_finish_cuda(x, contrast)


def fused_finish_reference(x: torch.Tensor,
                           contrast: bool = False) -> torch.Tensor:
    """Plain PyTorch form of ``fused_finish``."""
    global plain_calls
    _check(x)
    plain_calls += 1
    g = x.to(torch.float32)
    if contrast:
        g = contrast_brightness(g)
    return gaussian_blur3(g)


def _fused_finish_cuda(x: torch.Tensor, contrast: bool) -> torch.Tensor:
    global kernel_launches
    from lk_tpu_torch import _build

    _check(x)
    if not x.is_contiguous():
        raise ValueError("finish: frames must be contiguous (N, H, W)")
    lib = _build.library()
    n, h, w = x.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    k, b0, b1 = tone_constants()
    _build.launch(lib.lk_finish_launch, x, "finish", x.data_ptr(),
                  int(x.dtype == torch.uint8), out.data_ptr(), n, h, w,
                  int(contrast), k, b0, b1)
    kernel_launches += 1
    return out


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/finish.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_finish_launch.argtypes = [p, i, p, i, i, i, i, f, f, f, p]
    lib.lk_finish_launch.restype = i
