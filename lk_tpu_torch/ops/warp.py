"""Bilinear sampling and warping: counterpart of ``lk_tpu.ops.warp``
(``bilinear_sample``, ``warp_by_flow``, ``shift_select_warp``,
``extract_patch``).

``bilinear_sample`` / ``warp_by_flow`` are the 2-D gather warp, the oracle
lk_tpu's warp tests hold its kernels to.  ``shift_select_warp`` is the dense
XLA-path level's warp: a separable bilinear warp, vertical pass first, each
axis clamped to +-r with edge replication.  lk_tpu writes it as a
2r+2-term select loop because XLA on the TPU has no fast gather; exactly one
term of that loop is non-zero, so here each pass is two gathers and one
lerp, ``s0 + f * (s1 - s0)``, with the same numbers.  The separable order
is part of the result: the horizontal pass reads the intermediate at
``(y, x + d0x)``, which carries the dy of pixel ``(y, x + d0x)``, not of
``(y, x)`` — a second-order difference from the 2-D warp.
"""

from __future__ import annotations

from typing import Tuple

import torch


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (..., H, W) at float coords (x, y), clamped to the
    borders; x/y share any shape S, the result is img's leading dims + S."""
    h, w = img.shape[-2:]
    x = x.clamp(0.0, w - 1.0)
    y = y.clamp(0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(-1)
        return flat[..., idx].reshape(*img.shape[:-2], *yy.shape)

    v00 = at(y0i, x0i)
    v01 = at(y0i, x1i)
    v10 = at(y1i, x0i)
    v11 = at(y1i, x1i)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)), bilinear, border-clamped.  img: (H, W);
    flow: (H, W, 2) in (dx, dy) order."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] \
        .expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] \
        .expand(h, w)
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])


def _shift_axis(src: torch.Tensor, disp: torch.Tensor, r: int,
                axis: int) -> torch.Tensor:
    """One pass: src(i + d0) lerped toward src(i + d0 + 1) by the fraction,
    d = clip(disp, +-r), indices edge-clamped along ``axis``."""
    n = src.shape[axis]
    d_cl = disp.clamp(-r, r)
    d0 = torch.floor(d_cl)
    frac = d_cl - d0
    shape = [1] * src.ndim
    shape[axis] = n
    base = torch.arange(n, device=src.device).reshape(shape) \
        + d0.to(torch.int64)
    s0 = src.gather(axis, base.clamp(0, n - 1))
    s1 = src.gather(axis, (base + 1).clamp(0, n - 1))
    return s0 + frac * (s1 - s0)


def shift_select_warp(img: torch.Tensor, flow: torch.Tensor,
                      max_disp: Tuple[int, int]) -> torch.Tensor:
    """Bounded-displacement separable bilinear warp (module docstring).
    img: (H, W); flow: (H, W, 2) (dx, dy); max_disp: (rx, ry) integers."""
    rx, ry = max_disp
    x = img.to(torch.float32)
    tmp = _shift_axis(x, flow[..., 1], ry, axis=-2)      # vertical first
    return _shift_axis(tmp, flow[..., 0], rx, axis=-1)


def extract_patch(img: torch.Tensor, center: torch.Tensor,
                  win: Tuple[int, int]) -> torch.Tensor:
    """Bilinear (win_h, win_w) patch of img (H, W) around the float
    ``center`` = (x, y): integer offsets -half .. +half from the sub-pixel
    centre, the OpenCV LK window whose top-left is center - halfWin.

    A (win_h + 1, win_w + 1) slice and a 4-tap blend, as ``lk_tpu``.  The
    slice start follows ``lax.dynamic_slice``: a negative start counts from
    the end, as a Python index does, then the start is clamped to
    [0, H - win_h - 1] x [0, W - win_w - 1]; the blend fractions come from
    the unclamped corner.  So a corner left of (above) the image takes its
    slice from the right (bottom) part; callers gate validity separately.
    The start is computed on the device, with no host read."""
    win_w, win_h = win
    h, w = img.shape
    x0f = center[0] - (win_w - 1) * 0.5
    y0f = center[1] - (win_h - 1) * 0.5
    x0 = torch.floor(x0f)
    y0 = torch.floor(y0f)
    fx = (x0f - x0).to(img.dtype)
    fy = (y0f - y0).to(img.dtype)
    def start(c, n, size):
        c = c.to(torch.int64)
        c = torch.where(c < 0, c + n, c).clamp(0, n - size)
        return c + torch.arange(size, device=img.device)

    ys = start(y0, h, win_h + 1)
    xs = start(x0, w, win_w + 1)
    raw = img[ys[:, None], xs[None, :]]
    a, b = raw[:-1, :-1], raw[:-1, 1:]
    c, d = raw[1:, :-1], raw[1:, 1:]
    top = a + fx * (b - a)
    bot = c + fx * (d - c)
    return top + fy * (bot - top)
