"""lk.roadlines — road-line flow analytics (mirrors reference
LK2_road_line_detection.py).

Tracks 30 points inside the road trapezoid at width 960 with append-style
replenishment, accumulates per-segment length/angle stats, votes the
segments into the dominant road lines (``geometry.hough``), and emits the
post-run analytics plots (length-vs-index scatter and 100-bin histogram —
the reference's distribution.png / frequency.png, LK2:274-294 — and the
Hough accumulator; drawn with matplotlib).  ``compute`` is the tracking
and the voting alone, on the device.

Usage: python -m lk_tpu_torch.apps.roadlines <video> [--synthetic]
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from lk_tpu_torch.apps import _common
from lk_tpu_torch.apps.masking import tracker_preprocess
from lk_tpu_torch.config import FeatureConfig
from lk_tpu_torch.geometry.flowlines import flow_line_stats
from lk_tpu_torch.geometry.hough import HoughResult, hough_road_lines
from lk_tpu_torch.models import ROADLINES
from lk_tpu_torch.ops.rasterize import fill_convex_poly
from lk_tpu_torch.pipeline.tracker import make_tracker, run_tracker_frames


class RoadlinesResult(NamedTuple):
    lengths: List[float]            # every recorded segment, time order
    angles: List[float]
    hough: Optional[HoughResult]    # None when no segment was recorded
    start: np.ndarray               # (N, 2) f32 recorded segment starts
    stop: np.ndarray                # (N, 2) f32 ends
    frames: int                     # frames consumed
    width: int                      # processing size
    height: int


def add_args(parser):
    parser.add_argument("--dist-png", default="./distribution.png")
    parser.add_argument("--freq-png", default="./frequency.png")
    parser.add_argument("--hough-png", default="./hough.png")
    parser.add_argument("--hough-k", type=int, default=4,
                        help="dominant road lines to extract")
    return parser


def compute(args, device="cuda") -> RoadlinesResult:
    """Track the app's source on ``device`` and vote its segments."""
    preset = ROADLINES
    stream = _common.open_frames(args, device=device)
    w = preset["width"]
    h = int(stream.height * w / stream.width)
    quad = np.array(
        [[int(fx * w), int(fy * h)] for fx, fy in preset["trapezoid"]],
        np.int32,
    )
    mask = fill_convex_poly(h, w, quad)
    n_points = preset["n_points"]
    run_chunk, init = make_tracker(
        mask,
        lk=preset["lk"],
        features=FeatureConfig(max_corners=n_points),
        replenish_below=int(n_points * preset["replenish_below_frac"]),
        policy="append",
        device=device,
    )
    lengths, angles = [], []
    seg_old, seg_new = [], []

    def on_outputs(outs):
        st = flow_line_stats(outs.old_pts, outs.new_pts)
        old = outs.old_pts.cpu().numpy()
        new_ = outs.new_pts.cpu().numpy()
        m = outs.seg_mask.cpu().numpy()
        length = st.length.cpu().numpy()
        angle = st.angle.cpu().numpy()
        for k in range(old.shape[0]):
            if not m[k].any():
                continue
            # LK2 records every surviving track's segment, including
            # zero-length ones (LK2_road_line_detection.py:214-216)
            lengths.extend(length[k][m[k]].tolist())
            angles.extend(angle[k][m[k]].tolist())
            seg_old.append(old[k][m[k]])
            seg_new.append(new_[k][m[k]])

    n = run_tracker_frames(run_chunk, init, tracker_preprocess(h, w), stream,
                           args.chunk, max_frames=args.frames,
                           on_outputs=on_outputs, device=device)
    empty = np.zeros((0, 2), np.float32)
    old_all = (np.concatenate(seg_old).astype(np.float32) if seg_old
               else empty)
    new_all = (np.concatenate(seg_new).astype(np.float32) if seg_new
               else empty)
    hough = None
    if seg_old:
        # moving segments vote; zero-length ones have no line
        moving = (old_all != new_all).any(axis=1)
        hough = hough_road_lines(
            torch.from_numpy(old_all).to(device),
            torch.from_numpy(new_all).to(device),
            torch.from_numpy(moving).to(device), (w, h), k=args.hough_k)
    return RoadlinesResult(lengths, angles, hough, old_all, new_all, n, w, h)


def main(argv=None, device="cuda"):
    args = add_args(_common.build_parser(__doc__)).parse_args(argv)
    res = compute(args, device=device)
    if not args.quiet:
        print(f"frames: {res.frames}  segments: {len(res.lengths)}")
    _plots(res.lengths, args.dist_png, args.freq_png)
    if res.hough is not None:
        _hough_plot(res.hough, (res.width, res.height), args.hough_png)
        if not args.quiet:
            for t, r, v in zip(res.hough.theta.tolist(),
                               res.hough.rho.tolist(),
                               res.hough.votes.tolist()):
                if v > 0:
                    print(f"road line: theta={np.degrees(t):6.1f}deg "
                          f"rho={r:8.1f}px votes={v:.0f}")
    if not args.quiet:
        print(f"plots: {args.dist_png} {args.freq_png} {args.hough_png}")
    return res.lengths, res.angles, res.hough


def _plots(lengths, dist_png, freq_png):
    from lk_tpu_torch.viz import pyplot

    plt = pyplot()
    plt.figure(figsize=(12, 8), dpi=80)
    plt.title("Flow length distribution")
    plt.xlabel("segment index (time order)")
    plt.ylabel("length (px)")
    plt.scatter(np.arange(len(lengths)), lengths, 4)
    plt.savefig(dist_png)
    plt.close()

    plt.figure(figsize=(12, 8), dpi=80)
    plt.title("Flow length frequency")
    plt.xlabel("length (px)")
    plt.ylabel("count")
    plt.hist(lengths, bins=100)
    plt.savefig(freq_png)
    plt.close()


def _hough_plot(hough, image_size, png):
    from lk_tpu_torch.viz import pyplot

    plt = pyplot()
    w, h = image_size
    acc = hough.accumulator.cpu().numpy()
    rho_max = float(np.hypot(w, h))
    plt.figure(figsize=(12, 8), dpi=80)
    plt.title("Hough road-line votes (length-weighted)")
    plt.xlabel("rho (px)")
    plt.ylabel("theta (deg)")
    plt.imshow(acc, aspect="auto", origin="lower",
               extent=[-rho_max, rho_max, 0, 180], cmap="magma")
    plt.colorbar(label="votes")
    for t, r, v in zip(hough.theta.tolist(), hough.rho.tolist(),
                       hough.votes.tolist()):
        if v > 0:
            plt.plot(r, np.degrees(t), "c+", markersize=14)
    plt.savefig(png)
    plt.close()


if __name__ == "__main__":
    main()
