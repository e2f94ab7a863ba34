"""Shi–Tomasi corner selection (``cv.goodFeaturesToTrack``): counterpart of
``lk_tpu.features.shi_tomasi``.

1. dense min-eigenvalue response: Sobel-3 gradient products box-filtered
   (REFLECT_101) over blockSize, min eigenvalue of the 2x2 tensor;
2. 3x3 max-pool non-maximum suppression, threshold relative to the max
   response, optional mask;
3. greedy min-distance selection as iterative argmax + disc suppression,
   ``max_corners`` times (OpenCV's sorted-accept rule picks the same set).

Every function takes any leading batch shape: the pipeline selects corners
for all streams and ROI sub-masks at once.  Returns fixed-capacity slots
plus a validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from lk_tpu_torch.config import FeatureConfig
from lk_tpu_torch.ops.boxfilter import box_sum
from lk_tpu_torch.ops.gradients import sobel_derivatives


def min_eig_response(img: torch.Tensor, block_size: int = 7) -> torch.Tensor:
    """Dense Shi–Tomasi response over the trailing (H, W) axes."""
    ix, iy = sobel_derivatives(img)
    win = (block_size, block_size)
    # with a = A/2, c = C/2 the cross term stays unhalved:
    # lambda_min = (a + c) - sqrt((a - c)^2 + B^2)
    a = box_sum(ix * ix, win, border="reflect") * 0.5
    b = box_sum(ix * iy, win, border="reflect")
    c = box_sum(iy * iy, win, border="reflect") * 0.5
    return (a + c) - torch.sqrt((a - c) * (a - c) + b * b)


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max with -inf padding over the trailing (H, W) axes."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    x4 = F.pad(x4, (1, 1, 1, 1), value=float("-inf"))
    return F.max_pool2d(x4, 3, stride=1).reshape(lead + x.shape[-2:])


def good_features_to_track(
    img: torch.Tensor,
    mask: Optional[torch.Tensor],
    cfg: FeatureConfig = FeatureConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``cfg.max_corners`` corners of (..., H, W) images: ((...,
    max_corners, 2) xy, (..., max_corners) valid).  ``mask``: optional 0/1
    float (H, W) — corners only where mask > 0 (the reference's ROI
    sub-masks, LK_Final.py:488)."""
    return good_features_from_response(min_eig_response(img, cfg.block_size),
                                       mask, cfg)


def good_features_from_response(
    resp: torch.Tensor,
    mask: Optional[torch.Tensor],
    cfg: FeatureConfig = FeatureConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy corner selection from response maps (..., H, W); ``mask``
    broadcasts against them (corners only where mask > 0).  Returns
    ((..., max_corners, 2) xy float32, (..., max_corners) valid)."""
    h, w = resp.shape[-2:]
    lead = resp.shape[:-2] if mask is None else torch.broadcast_shapes(
        resp.shape, mask.shape)[:-2]
    if mask is not None:
        resp = torch.where(mask > 0, resp, 0.0)
    resp = resp.expand(lead + (h, w))
    max_resp = resp.amax(dim=(-2, -1), keepdim=True)
    thresh = max_resp * cfg.quality_level
    is_peak = (resp >= _max_pool3(resp)) & (resp > thresh) & (resp > 0)
    cand = torch.where(is_peak, resp, 0.0)

    min_d2 = cfg.min_distance * cfg.min_distance
    dev = resp.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    out_xy, out_valid = [], []
    for _ in range(cfg.max_corners):
        # two-stage argmax as lk_tpu: first maximal row, then its first
        # maximal column (torch.argmax returns the first maximum)
        row_max = cand.amax(dim=-1)
        yi = row_max.argmax(dim=-1)
        row = cand.gather(-2, yi[..., None, None].expand(lead + (1, w)))
        row = row[..., 0, :]
        xi = row.argmax(dim=-1)
        val = row_max.gather(-1, yi[..., None])[..., 0]
        x = xi.to(torch.float32)
        y = yi.to(torch.float32)
        take = val > 0
        out_xy.append(torch.where(take[..., None], torch.stack([x, y], -1),
                                  0.0))
        out_valid.append(take)
        d2 = (xs - x[..., None, None]) ** 2 + (ys - y[..., None, None]) ** 2
        cand = torch.where(take[..., None, None] & (d2 < min_d2), 0.0, cand)
    return torch.stack(out_xy, -2), torch.stack(out_valid, -1)

