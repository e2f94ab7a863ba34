"""Shared app plumbing: CLI args, stream setup, overlay rendering, sinks:
counterpart of ``lk_tpu.apps._common``.

The pipeline runs on the device (``device``, the card by default).  The
overlay reproduces the reference's drawing (tracks mask, VP dot, ROI
polygon — reference LK_Final.py:561-667) host-side with OpenCV; it is
presentation only, imported when asked for.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.io.sink import save_segments_pickle, save_vp_csv
from lk_tpu_torch.io.video import SyntheticRoadStream, open_stream
from lk_tpu_torch.pipeline.runner import VideoPipeline


def build_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("video", nargs="?", default=None,
                   help="path to the input video (or use --synthetic)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic driving scene")
    p.add_argument("--frames", type=int, default=None,
                   help="max frames to process")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames per device chunk")
    p.add_argument("--prefetch", type=int, default=2,
                   help="chunks decoded ahead on a producer thread "
                        "(0 = synchronous decode like the reference)")
    p.add_argument("--out-dir", default="./vps", help="CSV output directory")
    p.add_argument("--write-video", default=None,
                   help="write annotated video to this path (MJPG avi)")
    p.add_argument("--save-segments", default=None,
                   help="pickle accepted flow-line segments to this path")
    p.add_argument("--plot-vp", default=None,
                   help="write the CP/VP scatter (reference plot_vp) PNG here")
    p.add_argument("--all-lines-png", default=None,
                   help="write the accumulated flow-lines frame PNG here")
    p.add_argument("--stats-png", default=None,
                   help="write the VP-distribution scatter "
                        "(reference data_statistic) PNG here")
    p.add_argument("--checkpoint", default=None,
                   help="save final pipeline state to this .npz")
    p.add_argument("--resume", default=None,
                   help="resume pipeline state from this .npz")
    p.add_argument("--display", action="store_true",
                   help="live window with the reference's key protocol "
                        "(ESC quit, SPACE pause, BACKSPACE clear overlay); "
                        "needs a display")
    p.add_argument("--live-plot", action="store_true",
                   help="with --display: live CP/VP matplotlib scatter "
                        "updated per drained chunk (reference "
                        "SHOW_DNMC_PLOT, LK_Final.py:742-776)")
    p.add_argument("--quiet", action="store_true")
    return p


def video_name_of(args) -> str:
    if args.synthetic or args.video is None:
        return "synthetic"
    base = os.path.basename(args.video.replace("\\", "/"))
    return base.split(".")[0]


def open_frames(args, device="cuda"):
    """The app's source: the synthetic scene (1280x720, rendered on
    ``device``) or a video file (decoded on the host, needs OpenCV)."""
    if args.synthetic or args.video is None:
        n = args.frames or 120
        return SyntheticRoadStream(width=1280, height=720, n_frames=n,
                                   device=device)
    return open_stream(args.video)


def limited(src, max_frames: Optional[int]):
    """The first ``max_frames`` frames of ``src`` (all with None)."""
    for n_done, f in enumerate(src):
        if max_frames is not None and n_done >= max_frames:
            return
        yield f


def run_vp_app(cfg: PipelineConfig, args, device="cuda") -> VideoPipeline:
    """One video through ``VideoPipeline(cfg, ..., device=device)``, then
    the sinks and the artifacts the flags ask for."""
    stream = open_frames(args, device=device)
    pipe = VideoPipeline(cfg, src_size=(stream.width, stream.height),
                         chunk=args.chunk, device=device)
    if args.resume:
        pipe.resume_from(args.resume)
    t0 = time.perf_counter()
    if getattr(args, "display", False):
        from lk_tpu_torch.apps.display import Cv2UI, LivePlot, interactive_loop

        if not Cv2UI.available():
            raise RuntimeError(
                "--display needs a GUI and OpenCV (no $DISPLAY or no cv2 "
                "found); drop the flag to run headless, or use "
                "--write-video for the overlay")
        live = (LivePlot(pipe.width, pipe.height, window=cfg.vp_ref)
                if getattr(args, "live_plot", False) else None)
        try:
            interactive_loop(pipe, cfg, limited(stream, args.frames),
                             Cv2UI(), schematic=True, live_plot=live)
        finally:
            if live is not None:
                live.close()
    else:
        pipe.run(limited(stream, args.frames),
                 prefetch=getattr(args, "prefetch", 0))
    dt = time.perf_counter() - t0

    name = video_name_of(args)
    csv_path = save_vp_csv(pipe.csv_rows, name, args.out_dir)
    if args.save_segments:
        save_segments_pickle(pipe.segments, args.save_segments)
    if args.write_video:
        # second decode pass: frames stream straight into the encoder, so
        # host memory stays O(1) in video length (LK_Final.py:432-434)
        overlay_video(pipe, cfg,
                      limited(open_frames(args, device=device), args.frames),
                      args.write_video)
    if args.checkpoint and pipe.state is not None:
        pipe.save_checkpoint(args.checkpoint)
    vp = pipe.csv_rows[-1] if pipe.csv_rows else None
    rows = np.array(pipe.csv_rows, np.float64).reshape(-1, 2)
    if args.plot_vp:
        from lk_tpu_torch import viz

        viz.plot_vp_figure(
            rows, np.array(pipe.cross_points, np.float64).reshape(-1, 2),
            vp, pipe.width, pipe.height, out_path=args.plot_vp,
            window=cfg.vp_ref)
    if args.all_lines_png:
        from lk_tpu_torch import viz

        viz.all_lines_image(pipe.segments, pipe.width, pipe.height, vp,
                            out_path=args.all_lines_png)
    if args.stats_png:
        from lk_tpu_torch import viz

        viz.vp_distribution_figure(rows[:, 0], rows[:, 1], pipe.width,
                                   pipe.height, out_path=args.stats_png)
    if not args.quiet:
        print("-" * 30)
        print(f"frames: {pipe.frames_done}  wall: {dt:.1f}s "
              f"({pipe.frames_done / max(dt, 1e-9):.1f} fps)")
        print(f"total lines: {len(pipe.segments)}")
        print(f"csv: {csv_path} ({len(pipe.csv_rows)} rows)")
    return pipe


def overlay_video(pipe: VideoPipeline, cfg: PipelineConfig, raw_frames,
                  path: str, fps: int = 30) -> Optional[str]:
    """Re-render annotated frames (ROI polygon + center/VP dots) and encode.

    ``raw_frames`` is any iterable of source frames; each is encoded as soon
    as it is rendered, so memory stays constant regardless of clip length.
    Presentation path only (OpenCV); mirrors LK_Final.py:432-434,652-666.
    """
    from lk_tpu_torch.ops.rasterize import roi_mask_points
    from lk_tpu_torch.viz import require

    cv = require("cv2", "--write-video")
    w, h = pipe.width, pipe.height
    poly = roi_mask_points(w, h, cfg.roi)[[1, 3, 5, 7]]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    draw_mask = np.zeros((h, w, 3), np.uint8)
    # vp_per_frame is exactly one entry per processed frame (None while the
    # VP is hidden); csv_rows would drift — it holds a row per *update* too.
    # In a fresh run the first raw frame only initializes (never processed);
    # a resumed run processes every fed frame, so no offset then.
    lead = [None] if pipe.consumed_init_frame else []
    vps = iter(lead + pipe.vp_per_frame)
    for f in raw_frames:
        frame = cv.resize(f, (w, h), interpolation=cv.INTER_AREA)
        frame = cv.polylines(frame, [poly], True, (0, 0, 100), 2)
        frame = cv.circle(frame, (w // 2, h // 2), 6, (0, 0, 255), -1)
        vp_xy = next(vps, None)
        if vp_xy is not None and np.isfinite(vp_xy).all():
            frame = cv.circle(frame, (int(vp_xy[0]), int(vp_xy[1])), 6,
                              (0, 255, 100), -1)
        out.write(cv.add(frame, draw_mask))
    out.release()
    return path
