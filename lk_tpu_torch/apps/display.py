"""Interactive viewer: the reference's live window + key loop, optional:
counterpart of ``lk_tpu.apps.display``.

Reproduces the reference UI semantics (LK_Final.py:655-678,
VP_detection_using_optical_flow.py:668-695): the frame shown is the raw
resized frame plus an accumulating track overlay (``cv.add``), an FPS
counter drawn twice (dark outline + bright fill), and the key protocol —
ESC (27) quits, SPACE (32) pauses until the next SPACE, BACKSPACE (8)
clears the accumulated overlay (VP_det behavior).

The pipeline itself stays chunked on the device; the viewer drains after
every chunk and replays that chunk's frames with their per-frame VP.  Track
segments join the overlay at chunk granularity (the device computes a chunk
at a time — a documented presentation-only deviation from the reference's
per-frame accumulation).

The UI backend is injectable: ``Cv2UI`` drives a real window (requires a
display — gated by ``Cv2UI.available()``); tests script key sequences
through a stub.

Two further reference presentation behaviors are reproduced here:
``roi_schematic`` (the startup ROI animation — full trapezoid 200 ms, then
the four quadrant sub-masks 100 ms each, LK_Final.py:461-477) and
``LivePlot`` (the live CP/VP matplotlib scatter updated alongside the video
window — SHOW_DNMC_PLOT / plot_vp + mypause, LK_Final.py:742-776 — here
refreshed once per drained chunk, the same chunk-granularity deviation as
the track overlay).

Presentation runs on the host with a display: OpenCV (and matplotlib for
``LivePlot``) is imported inside the functions that draw, and a host
without it gets an ``ImportError`` naming what needed it.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from lk_tpu_torch.utils.profiling import FrameRateMeter
from lk_tpu_torch.viz import require

ESC, BACKSPACE, SPACE = 27, 8, 32


class Cv2UI:
    """Real cv2 window backend (``imshow`` + ``waitKey``)."""

    def __init__(self, window: str = "frame", wait_ms: int = 10):
        # waitKey(10) caps the loop at <=100 fps exactly like the
        # reference (LK_Final.py:672)
        self.window = window
        self.wait_ms = wait_ms

    @staticmethod
    def available() -> bool:
        if os.name != "nt" and not os.environ.get("DISPLAY"):
            return False
        try:
            import cv2  # noqa: F401

            return True
        except ImportError:
            return False

    def show(self, frame: np.ndarray) -> int:
        cv = require("cv2", "--display")
        cv.imshow(self.window, frame)
        return cv.waitKey(self.wait_ms) & 0xFF

    def show_hold(self, frame: np.ndarray, ms: int) -> int:
        """Show and hold for ``ms`` (the ROI schematic's waitKey(200)/100
        beats, LK_Final.py:462-477)."""
        cv = require("cv2", "--display")
        cv.imshow(self.window, frame)
        return cv.waitKey(ms) & 0xFF

    def wait_key(self) -> int:
        cv = require("cv2", "--display")
        return cv.waitKey(30) & 0xFF

    def close(self):
        cv = require("cv2", "--display")
        cv.destroyWindow(self.window)


def roi_schematic(ui, cfg, width: int, height: int) -> bool:
    """Startup ROI schematic animation (reference LK_Final.py:461-477):
    the full trapezoid mask held 200 ms, then each of the four quadrant
    sub-masks 100 ms.  Returns False if ESC was pressed during it."""
    from lk_tpu_torch.ops.rasterize import build_roi_masks

    full, subs = build_roi_masks(width, height, cfg.roi)
    show = getattr(ui, "show_hold", None) or (lambda f, ms: ui.show(f))
    frames = [(np.asarray(full, np.uint8) * 255, 200)]
    frames += [(np.asarray(s, np.uint8) * 255, 100) for s in subs]
    for img, ms in frames:
        if show(img, ms) == ESC:
            return False
    return True


class LivePlot:
    """Live CP/VP scatter window (reference SHOW_DNMC_PLOT: plot_vp +
    mypause, LK_Final.py:742-776), refreshed once per drained chunk.

    Same marks as the headless ``viz.plot_vp_figure``: red frame center,
    yellow recent cross points, blue VP history, black current VP.  On an
    interactive matplotlib backend the canvas redraws through a bounded
    event-loop tick so the cv2 window keeps focus (the reference's
    ``mypause`` exists for exactly that); on Agg (headless / tests) it
    just renders the figure.
    """

    def __init__(self, width: int, height: int, window: int = 300,
                 interval: float = 0.01):
        self._mpl = require("matplotlib", "--live-plot")
        self._plt = require("matplotlib.pyplot", "--live-plot")
        self.width, self.height = width, height
        self.window, self.interval = window, interval
        self.fig = self._plt.figure(figsize=(12, 8), dpi=80)
        self.updates = 0

    def update(self, vp_history, cross_points, vp) -> None:
        ax = self.fig.gca()
        ax.clear()
        w, h, win = self.width, self.height, self.window
        ax.set_title(f"Recent {win} Points")
        ax.scatter([w / 2], [h / 2], 100, "r")
        cp = np.asarray(cross_points, np.float64).reshape(-1, 2)[-win:]
        if len(cp):
            ax.scatter(cp[:, 0], cp[:, 1], 10, "y")
        hist = np.asarray(vp_history, np.float64).reshape(-1, 2)[-win:]
        if len(hist):
            ax.scatter(hist[:, 0], hist[:, 1], 20, "b")
        if vp is not None and np.isfinite(vp).all():
            ax.scatter([vp[0]], [vp[1]], 100, "black")
        ax.legend(["center", "cross points", "VPs history", "VP"])
        # fixed viewport, y inverted (reference LK_Final.py:763-765)
        ax.set_aspect("equal")
        ax.set_xlim(w // 3, w // 3 * 2)
        ax.set_ylim(h // 4 * 3, h // 3)
        self.updates += 1
        self._refresh()

    def _refresh(self) -> None:
        plt, mpl = self._plt, self._mpl
        if plt.rcParams["backend"] in getattr(mpl.rcsetup,
                                              "interactive_bk", ()):
            mgr = mpl._pylab_helpers.Gcf.get_active()
            if mgr is not None:
                if mgr.canvas.figure.stale:
                    mgr.canvas.draw()
                mgr.canvas.start_event_loop(self.interval)
                return
        self.fig.canvas.draw()

    def close(self) -> None:
        self._plt.close(self.fig)


def _render(raw, poly, vp_xy, draw_mask, fps):
    cv = require("cv2", "--display")
    h, w = draw_mask.shape[:2]
    frame = cv.resize(np.asarray(raw), (w, h), interpolation=cv.INTER_AREA)
    frame = cv.polylines(frame, [poly], True, (0, 0, 100), 2)
    frame = cv.circle(frame, (w // 2, h // 2), 6, (0, 0, 255), -1)
    if vp_xy is not None and np.isfinite(vp_xy).all():
        frame = cv.circle(frame, (int(vp_xy[0]), int(vp_xy[1])), 6,
                          (0, 255, 100), -1)
    # FPS drawn twice — dark outline then bright fill (LK_Final.py:655-660)
    txt = f"fps: {int(fps)}"
    frame = cv.putText(frame, txt, (20, 40), cv.FONT_HERSHEY_SIMPLEX,
                       1.0, (0, 0, 0), 4, cv.LINE_AA)
    frame = cv.putText(frame, txt, (20, 40), cv.FONT_HERSHEY_SIMPLEX,
                       1.0, (200, 255, 200), 1, cv.LINE_AA)
    return cv.add(frame, draw_mask)


def interactive_loop(pipe, cfg, frames, ui,
                     draw_mask: Optional[np.ndarray] = None,
                     schematic: bool = False,
                     live_plot: Optional["LivePlot"] = None) -> bool:
    """Feed ``frames`` through ``pipe`` chunk-wise, displaying each frame.

    Returns True if the stream completed, False on ESC quit.  ``ui`` must
    provide ``show(frame) -> keycode``, ``wait_key() -> keycode``, and
    ``close()``.  ``draw_mask`` is the accumulating track overlay (created
    fresh when None; injectable so tests can observe the BACKSPACE clear).
    ``schematic`` plays the startup ROI animation first; ``live_plot`` (a
    ``LivePlot``) refreshes the CP/VP scatter after every drained chunk.
    """
    from lk_tpu_torch.ops.rasterize import roi_mask_points

    cv = require("cv2", "--display")
    w, h = pipe.width, pipe.height
    poly = roi_mask_points(w, h, cfg.roi)[[1, 3, 5, 7]]
    if draw_mask is None:
        draw_mask = np.zeros((h, w, 3), np.uint8)
    meter = FrameRateMeter()
    rng = np.random.default_rng(0)  # per-track colors like the reference
    seg_seen = vp_seen = 0
    buf: List[np.ndarray] = []
    completed = True

    def show_chunk(chunk_frames) -> bool:
        nonlocal seg_seen, vp_seen
        pipe.drain()
        if live_plot is not None:
            vp = pipe.csv_rows[-1] if pipe.csv_rows else None
            live_plot.update(pipe.csv_rows, pipe.cross_points, vp)
        for seg in pipe.segments[seg_seen:]:
            a, b = seg["start"], seg["stop"]
            color = tuple(int(c) for c in rng.integers(0, 255, 3))
            cv.line(draw_mask, (int(a[0]), int(a[1])),
                    (int(b[0]), int(b[1])), color, 2)
        seg_seen = len(pipe.segments)
        for raw in chunk_frames:
            vp = (pipe.vp_per_frame[vp_seen]
                  if vp_seen < len(pipe.vp_per_frame) else None)
            vp_seen += 1
            key = ui.show(_render(raw, poly, vp, draw_mask, meter.tick()))
            if key == ESC:
                return False
            if key == BACKSPACE:  # clear overlay (VP_det.py:694-695)
                draw_mask[:] = 0
            if key == SPACE:  # pause until the next SPACE (or quit on ESC)
                while True:
                    k2 = ui.wait_key()
                    if k2 == SPACE:
                        break
                    if k2 == ESC:
                        return False
        return True

    pipe.drain_every = 1
    try:
        if schematic and not roi_schematic(ui, cfg, w, h):
            completed = False
            return False
        for f in frames:
            buf.append(f)
            if len(buf) < pipe.chunk + (1 if pipe.state is None else 0):
                continue
            fresh = pipe.state is None
            chunk = np.stack(buf)
            buf.clear()
            pipe.feed(chunk)
            # a fresh run consumes the first frame for initialization; only
            # processed frames have a vp_per_frame entry
            if not show_chunk(chunk[1:] if fresh else chunk):
                completed = False
                break
        if completed and buf:
            fresh = pipe.state is None
            chunk = np.stack(buf)
            pipe.feed(chunk)
            completed = show_chunk(chunk[1:] if fresh else chunk)
    finally:
        pipe.drain()
        ui.close()
    return completed
