"""ROI polygon masks: counterpart of ``lk_tpu.ops.rasterize``.

A convex polygon is the intersection of half-planes: the mask is a product
of edge sign tests on the pixel grid, pixels on an edge included.  The
masks are static per geometry, so they are built on the host with numpy
(float32, the same arithmetic as ``lk_tpu``) and moved to the device once
by the caller.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def fill_convex_poly(h: int, w: int, pts) -> np.ndarray:
    """(h, w) float32 0/1 mask of a convex polygon given as (N, 2) integer
    (x, y) vertices, CW or CCW."""
    pts = np.asarray(pts, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    x0, y0 = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    area2 = np.sum(x0 * y1 - x1 * y0, dtype=np.float32)
    orient = np.float32(1.0 if area2 >= 0 else -1.0)
    inside = np.ones((h, w), dtype=bool)
    for i in range(pts.shape[0]):
        ex = x1[i] - x0[i]
        ey = y1[i] - y0[i]
        cross = ex * (ys - y0[i]) - ey * (xs - x0[i])
        inside &= orient * cross >= 0
    return inside.astype(np.float32)


def masks_from_points(h: int, w: int, quads: Sequence[np.ndarray]
                      ) -> np.ndarray:
    """Stack of convex-quad masks, shape (len(quads), h, w) float32 0/1."""
    return np.stack([fill_convex_poly(h, w, q) for q in quads])


def roi_mask_points(width: int, height: int, roi) -> np.ndarray:
    """The 9 labeled ROI construction points (reference LK_Final.py:448-456):
    0 center, 1 bottom-left, 2 bottom-mid, 3 bottom-right, 4 mid-right,
    5 top-right, 6 top-mid, 7 top-left, 8 mid-left.  (9, 2) int32."""
    outer_l = int(width * roi.outer_l)
    inner_u = int(height * roi.inner_u)
    outer_r = int(width * roi.outer_r)
    outer_d = int(height * roi.outer_d)
    inner_l = int(width * roi.inner_l)
    inner_r = int(width * roi.inner_r)
    mid_y = (outer_d + inner_u) // 2
    return np.array(
        [
            [width // 2, mid_y],
            [outer_l, outer_d],
            [width // 2, outer_d],
            [outer_r, outer_d],
            [(outer_r + inner_r) // 2, mid_y],
            [inner_r, inner_u],
            [width // 2, inner_u],
            [inner_l, inner_u],
            [(outer_l + inner_l) // 2, mid_y],
        ],
        dtype=np.int32,
    )


def build_roi_masks(width: int, height: int, roi):
    """(full_mask (H, W), sub_masks (4, H, W)) float32 numpy: the road
    trapezoid on points [1,3,5,7] and its four quadrants around point 0
    (reference LK_Final.py:458-472)."""
    p = roi_mask_points(width, height, roi)
    full = fill_convex_poly(height, width, p[[1, 3, 5, 7]])
    subs = masks_from_points(
        height, width,
        [p[[0, 8, 1, 2]], p[[0, 2, 3, 4]], p[[0, 4, 5, 6]], p[[0, 6, 7, 8]]],
    )
    return full, subs
