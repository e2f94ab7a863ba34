"""lk.masking — donut-ROI tracker demo (mirrors reference LK1_masking.py).

Tracks up to 100 points inside a rectangular ring ROI at width 960, replaces
the pool when fewer than 25 survive, and renders the accumulated tracks.

Usage: python -m lk_tpu_torch.apps.masking <video> [--synthetic]
Outputs: the final tracks PNG (--tracks-png, default ./masking_tracks.png;
drawn with OpenCV).  ``compute`` is the tracking alone, on the device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from lk_tpu_torch.apps import _common
from lk_tpu_torch.config import FeatureConfig
from lk_tpu_torch.models import MASKING
from lk_tpu_torch.ops.blur import gaussian_blur3
from lk_tpu_torch.ops.color import bgr_to_gray
from lk_tpu_torch.ops.resize import resize_area
from lk_tpu_torch.pipeline.tracker import (donut_mask, make_tracker,
                                          run_tracker_frames)


class MaskingResult(NamedTuple):
    segments: List[Tuple[tuple, tuple]]   # ((x0, y0), (x1, y1)) per track
    frames: int                           # frames consumed
    width: int                            # processing size
    height: int


def tracker_preprocess(h: int, w: int):
    """(T, Hs, Ws, 3) u8 BGR on the device -> (T, h, w) f32: gray,
    INTER_AREA resize, 3x3 Gaussian (the LK1/LK2 apps' preprocess)."""

    def pre(frames: torch.Tensor) -> torch.Tensor:
        return gaussian_blur3(resize_area(
            bgr_to_gray(frames.to(torch.float32)), h, w))

    return pre


def compute(args, device="cuda") -> MaskingResult:
    """Track the app's source on ``device``; the segments of every frame."""
    preset = MASKING
    stream = _common.open_frames(args, device=device)
    w = preset["width"]
    h = int(stream.height * w / stream.width)
    mask = donut_mask(h, w, preset["outer"], preset["inner"], device=device)
    run_chunk, init = make_tracker(
        mask,
        lk=preset["lk"],
        features=FeatureConfig(max_corners=preset["n_points"]),
        replenish_below=preset["replenish_below"],
        policy="replace",
        device=device,
    )
    segs = []

    def on_outputs(outs):
        old = outs.old_pts.cpu().numpy()
        new_ = outs.new_pts.cpu().numpy()
        m = outs.seg_mask.cpu().numpy()
        for k in range(old.shape[0]):
            for a, b in zip(old[k][m[k]], new_[k][m[k]]):
                segs.append((tuple(a), tuple(b)))

    n = run_tracker_frames(run_chunk, init, tracker_preprocess(h, w), stream,
                           args.chunk, max_frames=args.frames,
                           on_outputs=on_outputs, device=device)
    return MaskingResult(segs, n, w, h)


def main(argv=None, device="cuda"):
    parser = _common.build_parser(__doc__)
    parser.add_argument("--tracks-png", default="./masking_tracks.png")
    args = parser.parse_args(argv)
    res = compute(args, device=device)
    if not args.quiet:
        print(f"frames: {res.frames}  segments: {len(res.segments)}")
    _render_tracks(res.segments, res.height, res.width, args.tracks_png)
    if not args.quiet:
        print(f"tracks: {args.tracks_png}")
    return res.segments


def _render_tracks(segs, h, w, path):
    from lk_tpu_torch.viz import require

    cv = require("cv2", "--tracks-png")
    img = np.zeros((h, w, 3), np.uint8)
    rng = np.random.default_rng(0)
    for (a, b) in segs:
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        cv.line(img, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])), color, 1)
    cv.imwrite(path, img)


if __name__ == "__main__":
    main()
