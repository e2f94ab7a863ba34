"""The masked point tracker of the LK1/LK2 pipelines: counterpart of
``lk_tpu.pipeline.tracker``.

A reduced pipeline (no VP machine): fixed-capacity point slots tracked
across frames inside an ROI mask by the per-point ``track_points``,
replenished when the live count drops below a threshold (replace, as
LK1_masking.py:152-153, or append and keep the newest, as
LK2_road_line_detection.py:245-260), with per-frame segments out.
Detection runs every frame and is kept only when the count is low, as in
``lk_tpu``'s scan: no host read decides it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lk_tpu_torch.config import FeatureConfig, LKConfig
from lk_tpu_torch.features.shi_tomasi import good_features_to_track
from lk_tpu_torch.flow.sparse import track_points
from lk_tpu_torch.pipeline.step import check_inside, compact_slots


class TrackerState(NamedTuple):
    prev_gray: torch.Tensor   # (H, W) f32
    pts: torch.Tensor         # (N, 2)
    valid: torch.Tensor       # (N,)


class TrackerOutputs(NamedTuple):
    old_pts: torch.Tensor     # (N, 2) segment starts
    new_pts: torch.Tensor     # (N, 2) segment ends
    seg_mask: torch.Tensor    # (N,) tracked this frame
    live: torch.Tensor        # () live slots after replenishment


def make_tracker(mask, lk: LKConfig = LKConfig(),
                 features: FeatureConfig = FeatureConfig(max_corners=100),
                 replenish_below: int = 25, policy: str = "replace",
                 device="cuda"):
    """(run_chunk, init) over ``TrackerState`` for a static ROI ``mask``
    (H, W), moved to ``device`` once.  ``policy``: "replace" (LK1) or
    "append" (LK2).  run_chunk(state, frames (T, H, W)) -> (state,
    TrackerOutputs stacked on T); init(first_gray (H, W)) -> state."""
    if policy not in ("replace", "append"):
        raise ValueError(policy)
    n = features.max_corners
    mask = torch.as_tensor(mask, dtype=torch.float32, device=device)

    def init(first_gray: torch.Tensor) -> TrackerState:
        gray = first_gray.to(torch.float32)
        pts, valid = good_features_to_track(gray, mask, features)
        return TrackerState(prev_gray=gray, pts=pts, valid=valid)

    def step(state: TrackerState, gray: torch.Tensor):
        gray = gray.to(torch.float32)
        p1, st, _ = track_points(state.prev_gray, gray, state.pts,
                                 state.valid, lk)
        st = check_inside(p1, mask, st)
        det_pts, det_valid = good_features_to_track(gray, mask, features)
        trigger = st.sum() < replenish_below
        kept = torch.where(st[:, None], p1, 0.0)
        if policy == "replace":
            pts_next = torch.where(trigger, det_pts, kept)
            valid_next = torch.where(trigger, det_valid, st)
        else:
            cp_, cv_ = compact_slots(kept, st)
            both_p = torch.cat([cp_, det_pts])
            both_v = torch.cat([cv_, det_valid])
            rank = torch.cumsum(both_v.to(torch.int64), dim=0)
            keep = both_v & (rank > (both_v.sum() - n).clamp(min=0))
            ap, av = compact_slots(torch.where(keep[:, None], both_p, 0.0),
                                   keep)
            pts_next = torch.where(trigger, ap[:n], kept)
            valid_next = torch.where(trigger, av[:n], st)
        out = TrackerOutputs(old_pts=state.pts, new_pts=p1,
                             seg_mask=st & state.valid,
                             live=valid_next.sum())
        return TrackerState(prev_gray=gray, pts=pts_next,
                            valid=valid_next), out

    def run_chunk(state: TrackerState, frames: torch.Tensor):
        outs = []
        for t in range(frames.shape[0]):
            state, o = step(state, frames[t])
            outs.append(o)
        return state, TrackerOutputs(*(torch.stack(x) for x in zip(*outs)))

    return run_chunk, init


def run_tracker_frames(run_chunk, init, preprocess, frames, chunk: int,
                       max_frames=None, on_outputs=None,
                       device="cuda") -> int:
    """Host loop feeding raw frames through a tracker in chunks.

    preprocess: a raw frame batch (T, Hs, Ws[, C]) on ``device`` ->
    processed (T, H, W).  on_outputs(outs): called with each chunk's
    stacked ``TrackerOutputs``.  The first frame initializes the tracker.
    Returns the number of frames consumed."""
    state = None
    buf = []
    n = 0

    def flush():
        nonlocal state
        grays = preprocess(torch.from_numpy(np.stack(buf)).to(device))
        if state is None:
            state = init(grays[0])
            grays = grays[1:]
            if grays.shape[0] == 0:
                return
        state, outs = run_chunk(state, grays)
        if on_outputs is not None:
            on_outputs(outs)

    for f in frames:
        if max_frames is not None and n >= max_frames:
            break
        buf.append(f)
        n += 1
        if len(buf) >= chunk + (1 if state is None else 0):
            flush()
            buf.clear()
    if buf:
        flush()
    return n


def donut_mask(h: int, w: int, outer: Tuple[float, float, float, float],
               inner: Tuple[float, float, float, float],
               device="cuda") -> torch.Tensor:
    """Rectangular ring ROI (LK1's donut crop, LK1:45-54,75-82): (h, w)
    float32 on ``device``; ``outer``/``inner`` are (left, top, right,
    bottom) fractions of the frame."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    ol, ou, orr, od = (outer[0] * w, outer[1] * h, outer[2] * w, outer[3] * h)
    il, iu, ir, idn = (inner[0] * w, inner[1] * h, inner[2] * w, inner[3] * h)
    in_outer = (xs >= ol) & (xs < orr) & (ys >= ou) & (ys < od)
    in_inner = (xs >= il) & (xs < ir) & (ys >= iu) & (ys < idn)
    return (in_outer & ~in_inner).to(torch.float32)
