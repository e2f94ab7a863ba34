"""2x flow upsample between pyramid levels: counterpart of
``lk_tpu.ops.resize.upsample2_linear``."""

from __future__ import annotations

import torch


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
    frac = torch.tensor([0.75, 0.25], dtype=torch.float32,
                        device=x.device).repeat(src).reshape(shape)
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
