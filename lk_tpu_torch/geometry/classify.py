"""Motion classification of flow lines relative to the vanishing point:
counterpart of ``lk_tpu.geometry.classify.classify_flow_lines``, over any
leading batch shape.

For forward ego-motion through a static scene, features stream away from
the VP; motion toward it, or mostly tangential, flags independent movers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

STATIC = 0        # |flow| below threshold
AWAY_FROM_VP = 1  # radially outward: consistent with forward ego-motion
TOWARD_VP = 2     # radially inward: oncoming relative motion
LATERAL = 3       # mostly tangential: crossing motion


class MotionSummary(NamedTuple):
    labels: torch.Tensor         # (..., N) int32
    frac_static: torch.Tensor    # (...,)
    frac_away: torch.Tensor
    frac_toward: torch.Tensor
    frac_lateral: torch.Tensor
    mean_radial: torch.Tensor    # mean signed radial speed (+ = away)
    mean_tangential: torch.Tensor


def classify_flow_lines(start: torch.Tensor, stop: torch.Tensor,
                        valid: torch.Tensor, vp_xy: torch.Tensor,
                        min_mag: float = 0.5, radial_frac: float = 0.7071
                        ) -> MotionSummary:
    """Label (..., N, 2) segments start -> stop relative to vp_xy (..., 2)."""
    vec = stop - start
    vx, vy = vec[..., 0], vec[..., 1]
    rx = start[..., 0] - vp_xy[..., 0:1]
    ry = start[..., 1] - vp_xy[..., 1:2]
    rn = torch.sqrt(rx * rx + ry * ry)
    pos = rn > 0
    rn1 = torch.where(pos, rn, 1.0)
    rxn = torch.where(pos, rx / rn1, 0.0)
    ryn = torch.where(pos, ry / rn1, 0.0)
    mag = torch.sqrt(vx * vx + vy * vy)
    radial = vx * rxn + vy * ryn
    tangential = -vx * ryn + vy * rxn
    moving = mag >= min_mag
    mostly_radial = radial.abs() >= radial_frac * mag
    labels = torch.where(
        ~moving, STATIC,
        torch.where(mostly_radial,
                    torch.where(radial > 0, AWAY_FROM_VP, TOWARD_VP),
                    LATERAL)).to(torch.int32)
    labels = torch.where(valid, labels, STATIC)

    v = valid.to(torch.float32)
    n = v.sum(dim=-1).clamp(min=1.0)
    mv = (moving & valid).to(torch.float32)
    nm = mv.sum(dim=-1).clamp(min=1.0)

    def frac(code):
        return ((labels == code) & valid).to(torch.float32).sum(dim=-1) / n

    return MotionSummary(
        labels=labels,
        frac_static=frac(STATIC), frac_away=frac(AWAY_FROM_VP),
        frac_toward=frac(TOWARD_VP), frac_lateral=frac(LATERAL),
        mean_radial=(radial * mv).sum(dim=-1) / nm,
        mean_tangential=(tangential * mv).sum(dim=-1) / nm,
    )
