"""Flow-line statistics and the EMA quality filter: counterpart of
``lk_tpu.geometry.flowlines``, over any leading batch shape.

Conventions preserved: the vector is y-flipped into math coordinates; the
length is rounded to 2 decimals (it feeds threshold comparisons); the angle
is in degrees in [0, 360); the accept rule is sequential over the slots of
a group, because the EMA-updated threshold reads each accepted line in slot
order (LK_Final.py:556-559), updating before (LK_Final) or after (LK3) the
test.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class FlowLineStats(NamedTuple):
    start: torch.Tensor    # (..., N, 2) image coords
    stop: torch.Tensor     # (..., N, 2)
    length: torch.Tensor   # (..., N) rounded to 2 decimals
    angle: torch.Tensor    # (..., N) degrees [0, 360)
    moving: torch.Tensor   # (..., N) bool — start != stop


def flow_line_stats(start: torch.Tensor, stop: torch.Tensor) -> FlowLineStats:
    """Flow lines from (..., N, 2) old/new point arrays."""
    start = start.to(torch.float32)
    stop = stop.to(torch.float32)
    vx = stop[..., 0] - start[..., 0]
    vy = -(stop[..., 1] - start[..., 1])
    norm = torch.sqrt(vx * vx + vy * vy)
    length = torch.round(norm * 100.0) / 100.0
    pos = norm > 0
    cosang = torch.where(
        pos, (vx / torch.where(pos, norm, 1.0)).clamp(-1.0, 1.0), 1.0)
    ang = torch.arccos(cosang) / math.pi * 180.0
    angle = torch.where(vy < 0, 360.0 - ang, ang)
    moving = (vx != 0) | (vy != 0)
    return FlowLineStats(start=start, stop=stop, length=length, angle=angle,
                         moving=moving)


def flow_line_filter(stats: FlowLineStats, valid: torch.Tensor,
                     avg_len: torch.Tensor, min_fl_len: float,
                     fl_update_rate: float, update_before_test: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential EMA filter over the last (slot) axis of one group's lines.

    Returns (accepted (..., N) bool, new avg_len (...,))."""
    r = fl_update_rate
    candidate = (valid & stats.moving & (stats.angle > 180.0)
                 & (stats.length > min_fl_len))
    avg = avg_len.to(torch.float32)
    accepted = []
    for k in range(candidate.shape[-1]):
        is_cand = candidate[..., k]
        length = stats.length[..., k]
        upd = (avg + length * r) / (1.0 + r)
        if update_before_test:
            accepted.append(is_cand & (length > torch.where(is_cand, upd,
                                                            avg)))
        else:
            accepted.append(is_cand & (length > avg))
        avg = torch.where(is_cand, upd, avg)
    return torch.stack(accepted, -1), avg
