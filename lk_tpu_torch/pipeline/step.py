"""The per-frame step of the VP pipeline: counterpart of
``lk_tpu.pipeline.step`` (``preprocess_frame``, ``check_inside``,
``compact_slots``, ``tracker_row_band`` and ``make_step``'s ``step``,
``detect``, ``_pre`` and ``_post`` (here one ``_update``, detecting every
frame between them) and ``step_batched``).

The layers run in the reference's order (LK_Final.py:508-705): track ->
ROI containment gate -> flow-line stats + EMA filter -> cross-point / VP
pair scan -> show/hide -> replenishment -> counters.  ``_update`` and
``detect`` work on a batch of B streams (leading axis), which
``lk_tpu`` gets by ``vmap``; the single-stream ``step`` tracks with the
per-point ``track_points`` and runs them on a batch of one.

The step reads nothing back to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.features.shi_tomasi import (good_features_from_response,
                                              min_eig_response)
from lk_tpu_torch.flow.sparse import (track_points,
                                      track_points_batched_prepped)
from lk_tpu_torch.geometry.classify import classify_flow_lines
from lk_tpu_torch.geometry.flowlines import flow_line_filter, flow_line_stats
from lk_tpu_torch.geometry.vanishing import (frame_candidates,
                                             process_frame_pairs,
                                             vp_show_step)
from lk_tpu_torch.ops.blur import gaussian_blur3
from lk_tpu_torch.ops.color import bgr_to_gray
from lk_tpu_torch.ops.resize import resize_area
from lk_tpu_torch.ops.tone import contrast_brightness
from lk_tpu_torch.pipeline.state import (FrameOutputs, PipelineState,
                                         slots_per_group, with_stream_axis,
                                         without_stream_axis)
from lk_tpu_torch.utils.profiling import span


def preprocess_frame(bgr: torch.Tensor, cfg: PipelineConfig, out_h: int,
                     out_w: int) -> torch.Tensor:
    """BGR (..., Hs, Ws, 3) -> gray -> INTER_AREA resize -> (optional tone)
    -> 3x3 blur, as ``lk_tpu`` (gray first: both are linear)."""
    gray = resize_area(bgr_to_gray(bgr.to(torch.float32)), out_h, out_w)
    if cfg.contrast_enhance:
        gray = contrast_brightness(gray)
    return gaussian_blur3(gray)


def check_inside(pts: torch.Tensor, mask: torch.Tensor,
                 status: torch.Tensor) -> torch.Tensor:
    """Reference checkInside (LK_Final.py:322-345) over (..., 2) points:
    status, in bounds, and the ROI mask at (floor(y), floor(x)) set."""
    h, w = mask.shape[-2:]
    x = torch.floor(pts[..., 0]).to(torch.int64)
    y = torch.floor(pts[..., 1]).to(torch.int64)
    in_bounds = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    inside = mask[y.clamp(0, h - 1), x.clamp(0, w - 1)] > 0
    return status & in_bounds & inside


def compact_slots(pts: torch.Tensor, valid: torch.Tensor):
    """Stable-move valid entries to the front of the last slot axis."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    return (pts.gather(-2, order[..., None].expand_as(pts)),
            valid.gather(-1, order))


def tracker_row_band(cfg: PipelineConfig, height: int, sub_masks):
    """Full-res (r0, r1) row interval every valid tracking point lives in
    (the ROI sub-masks' rows with a 16-row slack), or None when banding is
    off or the ROI is empty.  ``sub_masks``: numpy (4, H, W)."""
    if not cfg.track_row_band:
        return None
    rows = np.where((np.asarray(sub_masks) > 0).any(0).any(1))[0]
    if rows.size == 0:
        return None
    return (max(int(rows.min()) - 16, 0), min(int(rows.max()) + 17, height))


def make_step(cfg: PipelineConfig, frame_size: Tuple[int, int],
              roi_mask: np.ndarray, sub_masks: np.ndarray, device="cuda"):
    """The step functions for one geometry: (step, detect, step_batched).

    frame_size: (W, H) of the processed frames; roi_mask (H, W) and
    sub_masks (4, H, W) are the host masks of ``ops.rasterize``, moved to
    ``device`` here once.  ``step(state, gray (H, W))`` (one stream,
    single-stream state), ``detect(grays (B, H, W))`` and
    ``step_batched((states, prev_folded), grays (B, H, W))`` run on
    ``device``."""
    width, height = frame_size
    g = cfg.num_groups
    s = slots_per_group(cfg)
    masks_per_group = sub_masks.shape[0] // g
    fcfg = cfg.features
    row_band = tracker_row_band(cfg, height, sub_masks)
    roi_t = torch.as_tensor(roi_mask, dtype=torch.float32, device=device)

    # Corners only land inside the ROI sub-masks, so the response and the
    # greedy selection run on the ROI's bounding box (plus the response's
    # stencil halo), aligned as lk_tpu aligns it: the crop changes which
    # border pixels the response's REFLECT_101 reads.
    sub_np = np.asarray(sub_masks) > 0
    ys, xs = np.where(sub_np.any(0))
    if ys.size == 0:
        ys = np.array([0, height - 1])
        xs = np.array([0, width - 1])
    halo = fcfg.block_size // 2 + 2
    y0 = (max(int(ys.min()) - halo, 0) // 8) * 8
    x0 = (max(int(xs.min()) - halo, 0) // 128) * 128
    y1 = min(-(-(int(ys.max()) + 1 + halo) // 8) * 8, height)
    x1 = min(-(-(int(xs.max()) + 1 + halo) // 128) * 128, width)
    crop_off = torch.tensor([x0, y0], dtype=torch.float32, device=device)
    sub_crop = torch.as_tensor(np.asarray(sub_masks)[:, y0:y1, x0:x1],
                               dtype=torch.float32, device=device)

    def detect(gray: torch.Tensor):
        """Per-group corner pools in sub-mask order (LK_Final.py:481-492)
        of B frames: ((B, G, S, 2), (B, G, S))."""
        resp = min_eig_response(gray[:, y0:y1, x0:x1], fcfg.block_size)
        xy, val = good_features_from_response(resp[:, None], sub_crop, fcfg)
        xy = xy + crop_off                                  # (B, 4, C, 2)
        b = gray.shape[0]
        pxy = xy.reshape(b, g, masks_per_group * fcfg.max_corners, 2)
        pval = val.reshape(b, g, masks_per_group * fcfg.max_corners)
        pxy, pval = compact_slots(pxy, pval)
        pts = torch.where(pval[..., :s, None], pxy[..., :s, :], 0.0)
        return pts, pval[..., :s]

    def _update(state: PipelineState, gray, p1, st):
        """The new state and outputs of B streams from their tracked
        points: containment, flow lines, VP scan, show/hide, then
        replenishment from the frame's detection, which runs every frame
        (a stream that does not trigger ignores its pools)."""
        b = p1.shape[0]
        flat_pts = state.pts.reshape(b, g * s, 2)
        st = check_inside(p1, roi_t, st)
        new = p1.reshape(b, g, s, 2)
        surv = st.reshape(b, g, s)
        stats_all = flow_line_stats(flat_pts, p1)
        accepted_groups, new_avg = [], []
        for gi in range(g):
            stats_g = type(stats_all)(*(a[:, gi * s:(gi + 1) * s]
                                        for a in stats_all))
            acc, avg = flow_line_filter(
                stats_g, surv[:, gi], state.avg_len[:, gi], cfg.min_fl_len,
                cfg.fl_update_rate,
                update_before_test=cfg.avg_len_update_before_test)
            accepted_groups.append(acc)
            new_avg.append(avg)
        accepted = torch.cat(accepted_groups, dim=1)
        avg_len = torch.stack(new_avg, dim=1)

        pts_after = torch.where(surv[..., None], new, 0.0)
        live = surv.sum(dim=(1, 2))
        trigger = ((live < int(cfg.tp_num * cfg.tp_update_rate))
                   | (state.tp_ult == cfg.tp_update_time))

        with span("step.vp_scan"):
            cps_c, cand_c = frame_candidates(stats_all, accepted, cfg,
                                             (width, height))
            vp_state, geom = process_frame_pairs(
                state.vp, cps_c, cand_c, cfg, (width, height))
            vp_state, geom = vp_show_step(vp_state, geom, cfg)
        if cfg.reset_avg_len_on_hide:
            avg_len = torch.where(geom.vp_hidden[:, None], cfg.min_fl_len,
                                  avg_len)

        with span("step.detect"):
            det_pts, det_valid = detect(gray)
        if cfg.fl_upd_meth == "REP":
            do_rep = trigger & det_valid.any(dim=2).all(dim=1)
            pts_next = torch.where(do_rep[:, None, None, None], det_pts,
                                   pts_after)
            valid_next = torch.where(do_rep[:, None, None], det_valid, surv)
        elif cfg.fl_upd_meth == "EXT":
            # old survivors first, new appended, keep the newest s per group
            cp_, cv_ = compact_slots(pts_after, surv)
            both_p = torch.cat([cp_, det_pts], dim=2)
            both_v = torch.cat([cv_, det_valid], dim=2)
            n_tot = both_v.sum(dim=2, keepdim=True)
            rank = torch.cumsum(both_v.to(torch.int64), dim=2)
            keep = both_v & (rank > (n_tot - s).clamp(min=0))
            ext_p, ext_v = compact_slots(
                torch.where(keep[..., None], both_p, 0.0), keep)
            pts_next = torch.where(trigger[:, None, None, None],
                                   ext_p[:, :, :s], pts_after)
            valid_next = torch.where(trigger[:, None, None], ext_v[:, :, :s],
                                     surv)
        else:
            raise ValueError(cfg.fl_upd_meth)
        tp_ult = torch.where(trigger, 0, state.tp_ult) + 1
        new_state = PipelineState(prev_gray=gray, pts=pts_next,
                                  valid=valid_next, avg_len=avg_len,
                                  vp=vp_state, tp_ult=tp_ult)
        motion = classify_flow_lines(
            stats_all.start, stats_all.stop,
            accepted & vp_state.vp_init[:, None], vp_state.vp_xy)
        outputs = FrameOutputs(
            update_rows=geom.update_rows, update_mask=geom.update_mask,
            show_row=geom.show_row, show_mask=geom.show_mask,
            vp_hidden=geom.vp_hidden, cp_xy=geom.cp_xy, cp_mask=geom.cp_mask,
            line_start=stats_all.start, line_stop=stats_all.stop,
            line_mask=accepted, pts=new, pts_valid=surv, live_count=live,
            vp_xy=vp_state.vp_xy, vp_init=vp_state.vp_init,
            motion_labels=motion.labels,
            motion_fracs=torch.stack([motion.frac_static, motion.frac_away,
                                      motion.frac_toward,
                                      motion.frac_lateral], dim=-1),
        )
        return new_state, outputs

    def step(state: PipelineState, gray: torch.Tensor):
        """One frame of one stream: all G*S slots tracked by the per-point
        tracker, then ``_update`` on a batch of one stream."""
        gray = gray.to(torch.float32)
        p1, st, _err = track_points(state.prev_gray, gray,
                                    state.pts.reshape(g * s, 2),
                                    state.valid.reshape(g * s), cfg.lk)
        states = with_stream_axis(state)
        states, outs = _update(states, gray[None], p1[None], st[None])
        return without_stream_axis(states), without_stream_axis(outs)

    def step_batched(carry, grays: torch.Tensor):
        """Step B streams at once; carry = (states, prev_folded), the
        previous frame batch's tracker fold (``fold_tracking_levels``)."""
        states, prev_folded = carry
        grays = grays.to(torch.float32)
        b = grays.shape[0]
        p1, st, _err, next_folded = track_points_batched_prepped(
            prev_folded, grays, states.pts.reshape(b, g * s, 2),
            states.valid.reshape(b, g * s), cfg.lk, row_band=row_band)
        states, outs = _update(states, grays, p1, st)
        return (states, next_folded), outs

    return step, detect, step_batched
