"""Resampling: counterpart of ``lk_tpu.ops.resize`` (``area_weights``,
``linear_weights``, ``resize_area``, ``resize_linear``,
``upsample2_linear``, ``imutils_width_resize``).

The two resizes are f32 products with per-axis weight matrices,
``Wy @ img @ Wx^T`` (columns first, as ``lk_tpu``): ``torch.matmul``, no
kernel of the port's own, as ``lk_tpu`` leaves them to XLA.  The caller
keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False by
default): resize feeds sub-pixel tracking."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_AREA averaging weights (rows sum to 1)."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    for d in range(n_dst):
        a, b = d * scale, (d + 1) * scale
        s0, s1 = int(np.floor(a)), min(int(np.ceil(b)), n_src)
        for s in range(s0, s1):
            w[d, s] = (min(s + 1, b) - max(s, a)) / scale
    return w


@functools.lru_cache(maxsize=64)
def linear_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_LINEAR weights with half-pixel centers."""
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    scale = n_src / n_dst
    for d in range(n_dst):
        x = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), n_src - 1)
        b = min(max(x0 + 1, 0), n_src - 1)
        w[d, a] += 1.0 - f
        w[d, b] += f
    return w


def _apply_sep(img: torch.Tensor, wy: np.ndarray,
               wx: np.ndarray) -> torch.Tensor:
    dev = img.device
    y = torch.matmul(img.to(torch.float32), torch.from_numpy(wx).to(dev).T)
    return torch.matmul(torch.from_numpy(wy).to(dev), y)


def resize_area(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """INTER_AREA resize of the trailing (H, W) axes (module docstring)."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(img, area_weights(h, dst_h), area_weights(w, dst_w))


def resize_linear(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """INTER_LINEAR resize of the trailing (H, W) axes (module
    docstring)."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(img, linear_weights(h, dst_h),
                      linear_weights(w, dst_w))


def imutils_width_resize(img: torch.Tensor, width: int) -> torch.Tensor:
    """Aspect-preserving INTER_AREA resize to ``width`` with imutils'
    height, ``int(h * (width / float(w)))`` (LK_Final.py:429)."""
    h, w = img.shape[-2], img.shape[-1]
    return resize_area(img, int(h * (width / float(w))), width)


def _up_axis(x: torch.Tensor, dst: int, dim: int) -> torch.Tensor:
    src = x.shape[dim]
    if dst not in (2 * src, 2 * src - 1):
        raise ValueError(f"upsample2_linear: {src} -> {dst} is not ~2x")
    a = x.repeat_interleave(2, dim=dim)
    n = 2 * src
    # A[d-1] and A[d+1] with edge replication at the ends
    low = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim)
    high = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)
    shape = [1] * x.ndim
    shape[dim] = n
    # 0.75 at even positions, 0.25 at odd, filled on the device (a host
    # copy could not be captured in a CUDA graph)
    frac = torch.full((src, 2), 0.25, dtype=torch.float32, device=x.device)
    frac[:, 0] = 0.75
    frac = frac.reshape(shape)
    out = low * (1.0 - frac) + high * frac
    return out.narrow(dim, 0, dst)


def upsample2_linear(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """~2x linear upsample of the trailing (H, W) axes.

    Exact INTER_LINEAR for dst == 2*src; for the pyramid's ceil-half sizes
    (dst == 2*src - 1) the scale-2 taps are kept and the result cropped.
    out[d] = 0.25/0.75 blend of src[(d-1)//2] and src[(d+1)//2], rows first,
    then columns, as in ``lk_tpu``.
    """
    y = _up_axis(img.to(torch.float32), dst_h, img.ndim - 2)
    return _up_axis(y, dst_w, img.ndim - 1)
