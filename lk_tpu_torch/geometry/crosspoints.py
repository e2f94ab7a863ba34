"""Pairwise flow-line intersections (cross points): counterpart of
``lk_tpu.geometry.crosspoints``, keeping its IEEE quirks bit for bit:

* slope/intercept form in raw image coordinates;
* a vertical *second* argument (x4 == x3) is special-cased to x = x3, a
  vertical *first* argument divides by zero and propagates inf/nan;
* exactly parallel slopes give nan;
* the pair's argument order is swapped relative to the combinations order
  (reference LK_Final.py:576-577).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def PAIR_INDICES(n: int):
    """Static (i, j) index arrays for all i<j pairs in combinations order."""
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    a = np.array([p[0] for p in idx], dtype=np.int64)
    b = np.array([p[1] for p in idx], dtype=np.int64)
    return a, b


@functools.lru_cache(maxsize=16)
def pair_indices(n: int, device: torch.device):
    """``PAIR_INDICES(n)`` as index tensors on ``device``."""
    a, b = PAIR_INDICES(n)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def cross_point_pairs(start: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """All-pairs intersections of (..., N, 2) lines -> (..., P, 2) xy, nan
    where undefined.  Pair p intersects line1 = its *second* line (j) with
    line2 = its first (i)."""
    ii, jj = pair_indices(start.shape[-2], start.device)
    x1, y1 = start[..., jj, 0], start[..., jj, 1]
    x2, y2 = stop[..., jj, 0], stop[..., jj, 1]
    x3, y3 = start[..., ii, 0], start[..., ii, 1]
    x4, y4 = stop[..., ii, 0], stop[..., ii, 1]

    k1 = (y2 - y1) / (x2 - x1)            # vertical line1 -> inf propagates
    b1 = y1 - x1 * k1
    dx2 = x4 - x3
    vertical2 = dx2 == 0
    k2 = torch.where(vertical2, 0.0,
                     (y4 - y3) / torch.where(vertical2, 1.0, dx2))
    b2 = torch.where(vertical2, 0.0, y3 - x3 * k2)

    dk = k1 - k2
    parallel = dk == 0
    x_gen = (b2 - b1) / torch.where(parallel, 1.0, dk)
    x = torch.where(vertical2, x3,
                    torch.where(parallel, float("nan"), x_gen))
    y = k1 * x + b1
    y = torch.where(~vertical2 & parallel, float("nan"), y)
    return torch.stack([x, y], dim=-1)
