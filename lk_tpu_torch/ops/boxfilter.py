"""Windowed (box) sums: counterpart of ``lk_tpu.ops.boxfilter.box_sum``.

Two separable shifted-add passes, rows then columns, the taps added in
order, over an axis padded with zeros ("zero"), BORDER_REFLECT_101
("reflect") or edge replication ("edge").

``sum_dtype=torch.bfloat16`` pads and adds in bf16: every add rounds to
bf16, the last one of each pass too, as ``lk_tpu``'s ``box_sum`` does when
called op by op.  Under ``jax.jit`` XLA may keep the last add of the
column pass in f32 (excess precision); the port does not model that, and
differs from such a result by that one rounding, at most 2**-8 of the sum
(tests/test_torch_bf16.py pins both).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lk_tpu_torch.ops.blur import reflect101_index


def _pad_axis(a: torch.Tensor, before: int, after: int, axis: int,
              border: str) -> torch.Tensor:
    n = a.shape[axis]
    if border == "zero":
        shape = list(a.shape)
        parts = []
        for k in (before, None, after):
            if k is None:
                parts.append(a)
            elif k:
                shape[axis] = k
                parts.append(a.new_zeros(shape))
        return torch.cat(parts, axis)
    if border == "reflect":
        idx = reflect101_index(n, before, after, a.device)
    elif border == "edge":
        idx = torch.arange(-before, n + after, device=a.device).clamp(0, n - 1)
    else:
        raise ValueError(border)
    return a.index_select(axis, idx)


def box_sum(x: torch.Tensor, win: Tuple[int, int], border: str = "zero",
            sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """SAME windowed sum over the trailing (H, W) axes; ``win`` is
    (win_w, win_h) in OpenCV order.  The sums are taken in ``sum_dtype``
    and cast back to x's float dtype (float32 for integer input)."""
    win_w, win_h = win
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(sum_dtype)

    def axis_sum(a, k, axis):
        n = a.shape[axis]
        ap = _pad_axis(a, (k - 1) // 2, k // 2, axis, border)
        out = None
        for i in range(k):
            term = ap.narrow(axis, i, n)
            out = term if out is None else out + term
        return out

    return axis_sum(axis_sum(x, win_h, x.ndim - 2), win_w,
                    x.ndim - 1).to(out_dtype)
