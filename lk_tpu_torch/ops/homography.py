"""Perspective transform ops: counterpart of ``lk_tpu.ops.homography``
(the reference's bird's-eye experiment, LK3_classification.py:371-381).

``get_perspective_transform`` solves the 8-DOF homography from 4 point
correspondences (cv.getPerspectiveTransform's system) in f32;
``warp_perspective`` resamples through it with the port's bilinear gather
(``ops.warp.bilinear_sample``, border-clamped).  A setup-time / analysis
op, not on the per-frame path.
"""

from __future__ import annotations

import torch

from lk_tpu_torch.ops.warp import bilinear_sample


def get_perspective_transform(src, dst, device=None) -> torch.Tensor:
    """3x3 f32 homography H with dst ~ H @ src for 4 (x, y)
    correspondences, solved on ``device``: by default ``src``'s device
    when it is a tensor, else the card."""
    if device is None:
        device = src.device if isinstance(src, torch.Tensor) else "cuda"
    src = torch.as_tensor(src, dtype=torch.float32, device=device)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=device)
    one = torch.ones((), device=device)
    zero = torch.zeros((), device=device)
    rows, rhs = [], []
    for i in range(4):
        x, y = src[i, 0], src[i, 1]
        u, v = dst[i, 0], dst[i, 1]
        rows.append(torch.stack([x, y, one, zero, zero, zero, -x * u,
                                 -y * u]))
        rows.append(torch.stack([zero, zero, zero, x, y, one, -x * v,
                                 -y * v]))
        rhs.extend([u, v])
    h8 = torch.linalg.solve(torch.stack(rows), torch.stack(rhs))
    return torch.cat([h8, one[None]]).reshape(3, 3)


def warp_perspective(img: torch.Tensor, h_mat, out_h: int,
                     out_w: int) -> torch.Tensor:
    """out(p) = img(H^-1 p), bilinear, border-clamped
    (cv.warpPerspective's mapping; OpenCV fills the outside with zeros)."""
    dev = img.device
    hinv = torch.linalg.inv(torch.as_tensor(h_mat, dtype=torch.float32,
                                            device=dev))
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None] \
        .expand(out_h, out_w)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :] \
        .expand(out_h, out_w)
    coords = torch.stack([xs, ys, torch.ones_like(xs)])        # (3, H, W)
    mapped = torch.einsum("ij,jhw->ihw", hinv, coords)
    sx = mapped[0] / mapped[2]
    sy = mapped[1] / mapped[2]
    return bilinear_sample(img.to(torch.float32), sx, sy)
