"""The plain reference of the single-stream VP pipeline (preset ``final``,
``VideoPipeline`` as ``apps/final.py`` runs it), in float64, independent of
the program.

Written from ``lk_tpu``'s stated semantics and the reference scripts'
lines (LK_Final.py:22-54, :508-705), in plain PyTorch; it imports nothing
of the program.  Where it can, it takes the unchanged parts of
``reference/vp.py`` (the pyramid, derivatives, flow lines, cross points,
the VP scan, the show step, Shi-Tomasi corners, the sinks' rows and the
compared numbers).  It adds:

(a) ``preprocess``: one BGR u8 frame as the device preprocess takes it:
    gray = 0.299 R + 0.587 G + 0.114 B, unrounded; then INTER_AREA as
    exact area averaging (each output pixel the mean of the source area it
    covers, fractional pixels weighted by the share covered); then the 3x3
    Gaussian [1,2,1]/4, horizontal pass first, BORDER_REFLECT_101;
(b) ``track``: the per-point tracker as ``track_points`` states it,
    OpenCV's pyramidal LK reading each level whole: every level padded by
    max(win) + 2 pixels with REFLECT_101 (reflected again where the pad
    reaches past the far edge), Scharr derivatives ([3,10,3]/16 across,
    [-1,0,1]/2 along) of the padded level with REFLECT_101 at its own
    border, the bilinear (win_h, win_w) windows at p / 2^L - half with
    their integer corner clamped into the padded level, the structure
    tensor, the min-eigenvalue gate (``min_eig_threshold`` x 1024 over 2
    win_w win_h) and det > 1e-7, up to ``max_iters`` steps delta = A^-1 b
    with the eps stop and OpenCV's half step where successive steps cancel,
    the 'inside' tests (corner within [-win, size)), status from level 0;
(c) ``step``: one single-stream step of B frames (each its own stream
    state) from the program's state before frame t and the processed
    frames t - 1 and t, composed of (b) and ``vp.py``'s parts: the
    containment, the avg-len filter, the cross points and VP scan, the
    show step and REP replenishment, as ``vp.step`` composes them;
(d) ``initial_state``: the state a clip starts from on its first processed
    frame.

Departures from OpenCV, each as the program has it (lk_tpu):

* The gray is not rounded to u8 before the resize, and the resize is not
  rounded either (cv.cvtColor and cv.resize on u8 frames round both):
  the device preprocess keeps them in float.
* The tracker reads the Scharr derivatives of the padded level, so in the
  pad the x derivative of a reflected column is the reflection of its
  negative; OpenCV pads the derivative planes with zeros.  Only windows
  within 17 px of a level's edge read the pad.
* Shi-Tomasi and the ring of cross points as ``vp.py`` states them.

``low_precision=True`` is the check's control: the processed frames
rounded to bfloat16 and every step in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.vp import (SCHARR, Config, Geometry, _bilinear,
                                   _window, corners, cross_points,
                                   derivatives, finish, flow_lines,
                                   pyr_down, show_step, vp_scan)

__all__ = ["Config", "Geometry", "preprocess", "track", "step",
           "initial_state"]


# ---------------------------------------------------------------------------
# (a) the preprocess
# ---------------------------------------------------------------------------

def area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) float64 INTER_AREA weights: output pixel d covers
    source [d s, (d + 1) s), s = n_src / n_dst; each source pixel weighs
    the length of its overlap with that interval, over s."""
    scale = n_src / n_dst
    lo = np.arange(n_dst)[:, None] * scale
    src = np.arange(n_src)[None, :]
    overlap = (np.minimum(src + 1, lo + scale) - np.maximum(src, lo))
    return np.clip(overlap, 0, None) / scale


def preprocess(bgr_u8: torch.Tensor, height: int, width: int,
               low_precision: bool = False) -> torch.Tensor:
    """(B, Hs, Ws, 3) u8 BGR -> (B, height, width) processed frames in
    float64; the control rounds them to bfloat16."""
    x = bgr_u8.to(torch.float64)
    gray = 0.299 * x[..., 2] + 0.587 * x[..., 1] + 0.114 * x[..., 0]
    dev = bgr_u8.device
    wy = torch.from_numpy(area_weights(gray.shape[-2], height)).to(dev)
    wx = torch.from_numpy(area_weights(gray.shape[-1], width)).to(dev)
    small = wy @ gray @ wx.T
    return finish(small, torch.float64, low_precision)


# ---------------------------------------------------------------------------
# (b) the per-point tracker, whole levels
# ---------------------------------------------------------------------------

def _reflect_periodic(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """REFLECT_101 padding of ``pad`` along ``dim``, reflected again where
    the pad reaches past the far edge (np.pad's 'reflect')."""
    n = x.shape[dim]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x.index_select(dim, torch.zeros_like(i))
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return x.index_select(dim, torch.where(i >= n, period - i, i))


def track(prev_levels, next_levels, pts, valid, lk):
    """OpenCV's pyramidal LK of (B, N, 2) points from the prev levels to the
    next, each a list of (B, h, w) planes, level 0 first, every window read
    from the whole padded level.  Returns (new points (B, N, 2), status
    (B, N))."""
    bsz, n = pts.shape[:2]
    dev, dt = pts.device, pts.dtype
    win_w, win_h = lk.win_size
    half = torch.tensor([(win_w - 1) / 2, (win_h - 1) / 2], dtype=dt,
                        device=dev)
    pad = max(win_w, win_h) + 2
    b = torch.arange(bsz, device=dev).repeat_interleave(n)
    p0 = pts.reshape(-1, 2)
    ok0 = valid.reshape(-1)
    top = lk.max_level
    guess = p0 / 2 ** top
    status = ok0.clone()
    for lv in range(top, -1, -1):
        if lv != top:
            guess = guess * 2
        h, w = prev_levels[lv].shape[-2:]
        prev_p, next_p = (_reflect_periodic(_reflect_periodic(x, pad, -1),
                                            pad, -2)
                          for x in (prev_levels[lv], next_levels[lv]))
        ix, iy = derivatives(prev_p, SCHARR)
        hp, wp = prev_p.shape[-2:]
        size = torch.tensor([w, h], device=dev)
        lo = torch.tensor([-win_w, -win_h], device=dev)
        corner_max = torch.tensor([wp - win_w - 1, hp - win_h - 1],
                                  device=dev)

        def corner(q):
            """(integer corner in the padded level, fraction, inside)."""
            iq = torch.floor(q - half)
            iqi = iq.to(torch.int64)
            inside = ((iqi >= lo) & (iqi < size)).all(-1)
            c = torch.minimum((iqi + pad).clamp(min=0), corner_max)
            return c, q - half - iq, inside

        c, f, prev_in = corner(p0 / 2 ** lv)
        pw, xw, yw = (_bilinear(_window(pl, b, c[:, 1], c[:, 0], win_h + 1,
                                        win_w + 1), f[:, 0], f[:, 1])
                      for pl in (prev_p, ix, iy))
        a11 = (xw * xw).sum((1, 2))
        a12 = (xw * yw).sum((1, 2))
        a22 = (yw * yw).sum((1, 2))
        det = a11 * a22 - a12 * a12
        lam = (a11 + a22 - torch.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) \
            / (2 * win_w * win_h)
        good = prev_in & (lam >= lk.min_eig_threshold * 1024) & (det > 1e-7)
        inv = torch.where(det > 1e-7, 1 / torch.where(det > 1e-7, det, 1.0),
                          0.0)

        pt = guess.clone()
        last = torch.zeros_like(pt)
        active = good.clone()
        stayed_in = torch.ones_like(active)
        for j in range(lk.max_iters):
            cj, gj, inside = corner(pt)
            jw = _bilinear(_window(next_p, b, cj[:, 1], cj[:, 0], win_h + 1,
                                   win_w + 1), gj[:, 0], gj[:, 1])
            diff = jw - pw
            b1 = (diff * xw).sum((1, 2))
            b2 = (diff * yw).sum((1, 2))
            delta = torch.stack([(a12 * b2 - a22 * b1) * inv,
                                 (a12 * b1 - a11 * b2) * inv], -1)
            move = active & inside
            new = torch.where(move[:, None], pt + delta, pt)
            go_on = move & ((delta * delta).sum(-1) > lk.eps * lk.eps)
            if j > 0:
                cancel = ((delta + last).abs() < 0.01).all(-1)
                new = torch.where((move & cancel)[:, None], new - delta / 2,
                                  new)
                go_on = go_on & ~cancel
            stayed_in = torch.where(active, inside, stayed_in)
            pt, last, active = new, delta, go_on
        if lv == 0:
            status = status & good & (stayed_in | ~good)
        guess = pt
    new_pts = torch.where(ok0[:, None], guess, p0)
    return new_pts.reshape(bsz, n, 2), status.reshape(bsz, n)


# ---------------------------------------------------------------------------
# (c) one step, (d) the seeded state
# ---------------------------------------------------------------------------

def _frames(x: torch.Tensor, low_precision: bool) -> torch.Tensor:
    """Processed frames in the step's precision: float64, or the control's
    bfloat16-rounded frames in float32."""
    if low_precision:
        return x.to(torch.bfloat16).to(torch.float32)
    return x.to(torch.float64)


def step(prev, nxt, state: dict, cfg: Config, geom: Geometry,
         low_precision: bool = False) -> dict:
    """One step of B single-stream states (``state``: the program's state
    before frame t, ``pts``, ``valid``, ``avg_len``, ``tp_ult`` and the VP
    state's fields under ``vp``, each with a leading axis of B) on their
    processed frames t - 1 and t (B, H, W).  Returns what ``vp.step``
    returns, for ``vp.Tally``."""
    dt = torch.float32 if low_precision else torch.float64
    g, s = cfg.num_groups, cfg.slots
    frames = torch.stack([_frames(prev, low_precision),
                          _frames(nxt, low_precision)])
    levels = [frames]
    for _ in range(cfg.lk.max_level):
        levels.append(pyr_down(levels[-1]))
    bsz = prev.shape[0]
    p0 = state["pts"].to(dt).reshape(bsz, g * s, 2)
    p1, st = track([lv[0] for lv in levels], [lv[1] for lv in levels], p0,
                   state["valid"].reshape(bsz, g * s), cfg.lk)

    # check_inside (LK_Final.py:322-345)
    xi = torch.floor(p1[..., 0]).to(torch.int64)
    yi = torch.floor(p1[..., 1]).to(torch.int64)
    inb = (xi >= 0) & (xi < cfg.width) & (yi >= 0) & (yi < cfg.height)
    surv = st & inb & geom.roi[yi.clamp(0, cfg.height - 1),
                               xi.clamp(0, cfg.width - 1)]

    # the avg-len EMA filter per group, in slot order (LK_Final.py:556-559)
    length, angle, moving = flow_lines(p0, p1)
    cand = surv & moving & (angle > 180) & (length > cfg.min_fl_len)
    avg = state["avg_len"].to(dt).clone()
    r = cfg.fl_update_rate
    accepted = torch.zeros_like(cand)
    for k in range(g * s):
        gi = k // s
        upd = (avg[:, gi] + length[:, k] * r) / (1 + r)
        bar = upd if cfg.avg_len_update_before_test else avg[:, gi]
        accepted[:, k] = cand[:, k] & (length[:, k]
                                       > torch.where(cand[:, k], bar,
                                                     avg[:, gi]))
        avg[:, gi] = torch.where(cand[:, k], upd, avg[:, gi])

    live = surv.sum(1)
    trigger = (live < int(cfg.tp_num * cfg.tp_update_rate)) \
        | (state["tp_ult"] == cfg.tp_update_time)

    # cross points of the accepted pairs, then the VP scan and show step
    pi, pj = geom.pi, geom.pj
    cps = cross_points(p0, p1, pi, pj)
    dang = (angle[:, pi] - angle[:, pj]).abs()
    ok = (accepted[:, pi] & accepted[:, pj] & (dang >= cfg.min_ang_dif)
          & (dang <= 360 - cfg.min_ang_dif))
    if cfg.cp_min_start_sep_frac > 0:
        ok = ok & ((p0[:, pi, 0] - p0[:, pj, 0]).abs()
                   >= cfg.width * cfg.cp_min_start_sep_frac)
    ok = ok & ~cps.isnan().any(-1) & (cps[..., 1] <= p0[:, pi, 1]) \
        & (cps[..., 1] <= p0[:, pj, 1])
    vp = {k: (x.to(dt) if x.is_floating_point() else x)
          for k, x in state["vp"].items()}
    vp, n_cp, n_upd, rows = vp_scan(vp, cps, ok, cfg)
    show_row = vp["vp_xy"]
    vp, shown = show_step(vp, cfg)

    # REP replenishment from frame t's corners
    det_xy, det_ok = corners(frames[1], geom, cfg)
    rep = trigger & det_ok.any(-1).all(-1)
    kept = torch.where(surv[..., None], p1, 0.0).reshape(bsz, g, s, 2)
    return dict(
        pts=p1, surv=surv, n_cp=n_cp, n_upd=n_upd, vp_xy=vp["vp_xy"],
        vp_init=vp["vp_init"], trigger=trigger, replenish=rep,
        next_pts=torch.where(rep[:, None, None, None], det_xy, kept),
        next_valid=torch.where(rep[:, None, None], det_ok,
                               surv.reshape(bsz, g, s)),
        show_row=show_row, shown=shown, **rows)


def initial_state(first, cfg: Config, geom: Geometry,
                  low_precision: bool = False) -> dict:
    """The state a clip starts from on its first processed frames (B, H,
    W): the frame as ``prev_gray``, its Shi-Tomasi corners in the slots,
    ``min_fl_len`` as every group's average length, and a VP state with
    nothing in it (no VP, empty rings, no alias)."""
    dt = torch.float32 if low_precision else torch.float64
    gray = _frames(first, low_precision)
    pts, ok = corners(gray, geom, cfg)
    b, dev = first.shape[0], first.device

    def z(*shape, dtype=dt):
        return torch.zeros((b,) + shape, dtype=dtype, device=dev)

    i64 = torch.int64
    return dict(
        prev_gray=gray, pts=pts, valid=ok,
        avg_len=torch.full((b, cfg.num_groups), float(cfg.min_fl_len),
                           dtype=dt, device=dev),
        tp_ult=z(dtype=i64),
        vp=dict(vp_xy=z(2), vp_init=z(dtype=torch.bool),
                vp_moved=z(dtype=torch.bool), ring_xy=z(cfg.vp_ref_num, 2),
                ring_total=z(dtype=i64),
                alias_pos=torch.full((b,), -1, dtype=i64, device=dev),
                vp_ult=z(dtype=i64), hist_xy=z(cfg.vp_ref, 2),
                hist_total=z(dtype=i64)))
