"""Motion classification relative to the vanishing point: counterpart of
``lk_tpu.geometry.classify`` (``classify_dense_flow``,
``classify_flow_lines``), over any leading batch shape.

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
    labels: torch.Tensor         # (..., N) or (..., H, W) int32
    frac_static: torch.Tensor    # (...,)
    frac_away: torch.Tensor
    frac_toward: torch.Tensor
    frac_lateral: torch.Tensor
    mean_radial: torch.Tensor    # mean signed radial speed (+ = away)
    mean_tangential: torch.Tensor


def _classify(vec_x, vec_y, pos_x, pos_y, vp_x, vp_y, min_mag,
              radial_frac):
    """(labels, radial, tangential, moving) of vectors at positions, the
    VP coordinates broadcasting against the positions."""
    rx = pos_x - vp_x
    ry = pos_y - vp_y
    rn = torch.sqrt(rx * rx + ry * ry)
    pos = rn > 0
    rn1 = torch.where(pos, rn, 1.0)
    rxn = torch.where(pos, rx / rn1, 0.0)
    ryn = torch.where(pos, ry / rn1, 0.0)
    mag = torch.sqrt(vec_x * vec_x + vec_y * vec_y)
    radial = vec_x * rxn + vec_y * ryn
    tangential = -vec_x * ryn + vec_y * rxn
    moving = mag >= min_mag
    mostly_radial = radial.abs() >= radial_frac * mag
    labels = torch.where(
        ~moving, STATIC,
        torch.where(mostly_radial,
                    torch.where(radial > 0, AWAY_FROM_VP, TOWARD_VP),
                    LATERAL)).to(torch.int32)
    return labels, radial, tangential, moving


def _summary(labels, radial, tangential, moving, valid, dims):
    """The class fractions over ``valid`` and the mean speeds over the
    valid moving vectors, reduced over ``dims``."""
    v = valid.to(torch.float32)
    n = v.sum(dim=dims).clamp(min=1.0)
    mv = (moving & valid).to(torch.float32)
    nm = mv.sum(dim=dims).clamp(min=1.0)

    def frac(code):
        return ((labels == code) & valid).to(torch.float32).sum(dim=dims) / n

    return MotionSummary(
        labels=labels,
        frac_static=frac(STATIC), frac_away=frac(AWAY_FROM_VP),
        frac_toward=frac(TOWARD_VP), frac_lateral=frac(LATERAL),
        mean_radial=(radial * mv).sum(dim=dims) / nm,
        mean_tangential=(tangential * mv).sum(dim=dims) / nm,
    )


def classify_dense_flow(flow: torch.Tensor, vp_xy: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        min_mag: float = 0.5, radial_frac: float = 0.7071
                        ) -> MotionSummary:
    """Label every pixel of (..., H, W, 2) flow relative to vp_xy (..., 2);
    ``valid`` (..., H, W) masks the summary (not the labels), all pixels
    when None."""
    h, w = flow.shape[-3:-1]
    dev = flow.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w)
    labels, radial, tangential, moving = _classify(
        flow[..., 0], flow[..., 1], xs, ys, vp_xy[..., 0, None, None],
        vp_xy[..., 1, None, None], min_mag, radial_frac)
    if valid is None:
        valid = torch.ones(flow.shape[:-1], dtype=torch.bool, device=dev)
    return _summary(labels, radial, tangential, moving, valid, (-2, -1))


def classify_flow_lines(start: torch.Tensor, stop: torch.Tensor,
                        valid: torch.Tensor, vp_xy: torch.Tensor,
                        min_mag: float = 0.5, radial_frac: float = 0.7071
                        ) -> MotionSummary:
    """Label (..., N, 2) segments start -> stop relative to vp_xy (..., 2);
    invalid segments are labelled STATIC."""
    vec = stop - start
    labels, radial, tangential, moving = _classify(
        vec[..., 0], vec[..., 1], start[..., 0], start[..., 1],
        vp_xy[..., 0:1], vp_xy[..., 1:2], min_mag, radial_frac)
    labels = torch.where(valid, labels, STATIC)
    return _summary(labels, radial, tangential, moving, valid, -1)
