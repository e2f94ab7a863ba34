"""The plain reference of one step of the VP pipeline (preset ``final``) of
B streams, in float64, independent of the program.

Written from ``lk_tpu``'s stated semantics and the reference scripts'
lines (LK_Final.py:508-705), in plain PyTorch; it imports nothing of the
program.  One step takes a stream's state before frame t (its tracking
points, average flow lengths, VP state and replenish counter) with the
staged u8 frames t - 1 and t, and gives what the program's step gives:

1. the serving finish: u8 to float, the 3x3 Gaussian [1,2,1]/4 (horizontal
   pass first, BORDER_REFLECT_101);
2. the tracking pyramid, cv.pyrDown per level (5 taps [1,4,6,4,1]/16,
   BORDER_REFLECT_101, output ceil(n/2)), ``max_level`` levels;
3. normalised Scharr derivatives of each prev level: [3,10,3]/16 across,
   [-1,0,1]/2 along, BORDER_REFLECT_101;
4. OpenCV's pyramidal LK for every slot: from the top level down, the
   bilinear (win_h, win_w) prev window and its gradients at p / 2^L - half,
   the structure tensor and its min eigenvalue over 2 win_w win_h, gated at
   ``min_eig_threshold`` x 1024 (OpenCV's fixed-point scale on normalised
   gradients) and det > 1e-7; then up to ``max_iters`` steps
   delta = A^-1 b, stopping where |delta|^2 <= eps^2, and where successive
   steps cancel (|delta + prev| < 0.01 on both axes) stepping back half a
   step; OpenCV's 'inside' tests (corner within [-win, size)); status from
   level 0 only;
5. ``check_inside`` against the ROI trapezoid: floor(x), floor(y) in the
   frame and on the mask (LK_Final.py:322-345);
6. flow lines (vector y-flipped, length rounded to 2 decimals, angle in
   degrees), the avg-len EMA filter per group in slot order, updated before
   the accept test (LK_Final.py:556-559);
7. cross points of every accepted pair with an angle difference of at
   least ``min_ang_dif`` (slope-intercept in image coordinates, the pair's
   second line first, LK_Final.py:576-577), above both starts, not nan;
8. the VP scan over them in pair order: accept within W, H x ``cp_thold``
   of an initialised VP (any before), append to the ring of
   ``vp_ref_num``; once initialised, move by ``vp_update_rate`` x the mean
   of the differences kept by the mean +- std x ``max_cp_std`` clip; the
   first ``vp_ref_num`` accepted give the initial VP, and the ring entry
   appended last then reads as the VP until it leaves the ring
   (``vp_init_aliasing``, LK_Final.py:617-624);
9. the show/hide block: hide after ``hide_vp_thold`` frames without an
   update (LK_Final.py:627-649);
10. replenishment (REP) when fewer than tp_num x tp_update_rate points
    live or every ``tp_update_time`` frames: Shi-Tomasi on frame t (Sobel
    [1,2,1]/4 x [-1,0,1]/2, 7x7 box sums BORDER_REFLECT_101, lambda_min),
    per ROI sub-mask the 3x3 maxima above quality x the mask's largest
    response, greedily the largest (first in row order) and clearing a
    disc of ``min_distance``, ``max_corners`` times; each group's two
    sub-masks' corners compacted into its slots; taken only when every
    group found one.

Departures, each as the program has it (lk_tpu's batched tracker):

* The tracker reads frame t inside a superwindow of 32 x 48 pixels placed
  around each point's starting guess at each level; a window that would
  leave it is clamped into it.  OpenCV reads the whole level.
* The Shi-Tomasi response is taken on the sub-masks' bounding box grown by
  5 px, not the whole frame (lk_tpu crops too, aligned to 8 rows and 128
  columns): a masked pixel's response reads 4 px around it, so neither
  crop changes a corner.
* The ring of the last ``vp_ref_num`` cross points and the VP history are
  kept as arrays with append counters, as lk_tpu keeps them.

``low_precision=True`` is the check's control: the finished frames rounded
to bfloat16 and every step in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the batched tracker's superwindow of frame t, rows x columns
SUPER_H, SUPER_W = 32, 48


class Config:
    """The configuration file's fields the step reads, as attributes
    (``cfg.lk.win_size``, ``cfg.features.max_corners``, ...)."""

    def __init__(self, config: dict):
        self.height, self.width = config["height"], config["width"]
        for k, v in config["pipeline"].items():
            setattr(self, k, v)
        self.lk = _Fields(config["lk"])
        self.features = _Fields(config["features"])
        self.roi = _Fields(config["roi"])
        if self.fl_upd_meth != "REP" or self.contrast_enhance:
            raise ValueError("the reference covers preset final's step "
                             "(REP replenishment, no tone curve)")
        self.slots = self.tp_num // self.num_groups


class _Fields:
    def __init__(self, d: dict):
        self.__dict__.update(d)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _convex(h: int, w: int, quad) -> np.ndarray:
    """(h, w) bool mask of a convex polygon with integer vertices: every
    edge's cross product with the pixel on the inner side or on the edge."""
    q = np.asarray(quad, np.int64)
    ys, xs = np.mgrid[0:h, 0:w]
    x0, y0 = q[:, 0], q[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    sign = 1 if np.sum(x0 * y1 - x1 * y0) >= 0 else -1
    inside = np.ones((h, w), bool)
    for i in range(len(q)):
        cross = (x1[i] - x0[i]) * (ys - y0[i]) - (y1[i] - y0[i]) * (xs - x0[i])
        inside &= sign * cross >= 0
    return inside


def roi_masks(cfg: Config):
    """(road trapezoid (H, W), its four quadrants (4, H, W)) as bool numpy
    (LK_Final.py:437-472): points 0 centre, 1-3 bottom left/mid/right, 4
    mid right, 5-7 top right/mid/left, 8 mid left."""
    w, h, r = cfg.width, cfg.height, cfg.roi
    ol, iu, orr, od = (int(w * r.outer_l), int(h * r.inner_u),
                       int(w * r.outer_r), int(h * r.outer_d))
    il, ir = int(w * r.inner_l), int(w * r.inner_r)
    my = (od + iu) // 2
    p = [(w // 2, my), (ol, od), (w // 2, od), (orr, od),
         ((orr + ir) // 2, my), (ir, iu), (w // 2, iu), (il, iu),
         ((ol + il) // 2, my)]
    full = _convex(h, w, [p[1], p[3], p[5], p[7]])
    quads = [(0, 8, 1, 2), (0, 2, 3, 4), (0, 4, 5, 6), (0, 6, 7, 8)]
    subs = np.stack([_convex(h, w, [p[i] for i in q]) for q in quads])
    return full, subs


class Geometry:
    """What one frame geometry fixes, on ``device``: the ROI masks, the
    detection crop, the pairs of lines."""

    def __init__(self, cfg: Config, device):
        full, subs = roi_masks(cfg)
        self.roi = torch.as_tensor(full, device=device)
        ys, xs = np.nonzero(subs.any(0))
        m = 5
        self.crop = (max(int(ys.min()) - m, 0),
                     min(int(ys.max()) + 1 + m, cfg.height),
                     max(int(xs.min()) - m, 0),
                     min(int(xs.max()) + 1 + m, cfg.width))
        y0, y1, x0, x1 = self.crop
        self.subs = torch.as_tensor(subs[:, y0:y1, x0:x1], device=device)
        n = cfg.tp_num
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
        self.pi = torch.tensor([p[0] for p in pairs], device=device)
        self.pj = torch.tensor([p[1] for p in pairs], device=device)


# ---------------------------------------------------------------------------
# image operations (trailing (H, W) axes)
# ---------------------------------------------------------------------------

def _reflect(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of ``pad`` along ``dim``."""
    n = x.shape[dim]
    i = torch.arange(-pad, n + pad, device=x.device).abs()
    i = torch.where(i >= n, 2 * n - 2 - i, i)
    return x.index_select(dim, i)


def _correlate(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    r = len(taps) // 2
    xp = _reflect(x, r, dim)
    n = x.shape[dim]
    return sum(xp.narrow(dim, k, n) * t for k, t in enumerate(taps))


def finish(frames_u8: torch.Tensor, dtype, low_precision: bool):
    """The serving finish of u8 frames in ``dtype``; the control rounds
    the finished frames to bfloat16."""
    g = _correlate(_correlate(frames_u8.to(dtype), (0.25, 0.5, 0.25), -1),
                   (0.25, 0.5, 0.25), -2)
    return g.to(torch.bfloat16).to(dtype) if low_precision else g


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv.pyrDown: the 5-tap filter on both axes, even pixels kept."""
    taps = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)
    x = _correlate(x, taps, -1)[..., ::2]
    return _correlate(x, taps, -2)[..., ::2, :]


def derivatives(x: torch.Tensor, smooth):
    """(d/dx, d/dy): ``smooth`` across, [-1, 0, 1]/2 along."""
    diff = (-0.5, 0.0, 0.5)
    return (_correlate(_correlate(x, smooth, -2), diff, -1),
            _correlate(_correlate(x, smooth, -1), diff, -2))


SCHARR = (3 / 16, 10 / 16, 3 / 16)
SOBEL = (0.25, 0.5, 0.25)


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

def _window(plane_p, b, cy, cx, rows, cols):
    """(n, rows, cols) patches of padded planes (B, Hp, Wp) at corners."""
    r = cy[:, None] + torch.arange(rows, device=cy.device)
    c = cx[:, None] + torch.arange(cols, device=cx.device)
    return plane_p[b[:, None, None], r[:, :, None], c[:, None, :]]


def _bilinear(patch, fx, fy):
    """Bilinear (h, w) windows of (..., n, h + 1, w + 1) patches."""
    fx, fy = fx[:, None, None], fy[:, None, None]
    return ((1 - fy) * ((1 - fx) * patch[..., :-1, :-1]
                        + fx * patch[..., :-1, 1:])
            + fy * ((1 - fx) * patch[..., 1:, :-1] + fx * patch[..., 1:, 1:]))


def track(prev_levels, next_levels, pts, valid, lk):
    """OpenCV's pyramidal LK of (B, N, 2) points from the prev levels to the
    next, each a list of (B, h, w) planes, level 0 first.  Returns
    (new points (B, N, 2), status (B, N))."""
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
        prev, nxt = prev_levels[lv], next_levels[lv]
        h, w = prev.shape[-2:]
        size = torch.tensor([w, h], device=dev)
        lo = torch.tensor([-win_w, -win_h], device=dev)
        ix, iy = derivatives(prev, SCHARR)
        planes = [_reflect(_reflect(x, pad, -1), pad, -2)
                  for x in (prev, ix, iy, nxt)]
        hp, wp = planes[0].shape[-2:]
        corner_max = torch.tensor([wp - win_w - 1, hp - win_h - 1],
                                  device=dev)

        q = p0 / 2 ** lv - half
        iq = torch.floor(q)
        f = q - iq
        iqi = iq.to(torch.int64)
        prev_in = ((iqi >= lo) & (iqi < size)).all(-1)
        c = (iqi + pad).clamp(min=0)
        c = torch.minimum(c, corner_max)
        wins = [_bilinear(_window(pl, b, c[:, 1], c[:, 0], win_h + 1,
                                  win_w + 1), f[:, 0], f[:, 1])
                for pl in planes[:3]]
        pw, xw, yw = wins
        a11 = (xw * xw).sum((1, 2))
        a12 = (xw * yw).sum((1, 2))
        a22 = (yw * yw).sum((1, 2))
        det = a11 * a22 - a12 * a12
        lam = (a11 + a22 - torch.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) \
            / (2 * win_w * win_h)
        good = prev_in & (lam >= lk.min_eig_threshold * 1024) & (det > 1e-7)
        inv = torch.where(det > 1e-7, 1 / torch.where(det > 1e-7, det, 1.0),
                          0.0)

        # the superwindow of the next level around the starting guess
        sh, sw = min(SUPER_H, hp), min(SUPER_W, wp)
        s_lo = (torch.floor(guess - half).to(torch.int64) + pad
                - torch.tensor([(sw - win_w - 1) // 2, (sh - win_h - 1) // 2],
                               device=dev))
        s_lo = torch.minimum(s_lo.clamp(min=0),
                             torch.tensor([wp - sw, hp - sh], device=dev))
        s_max = torch.tensor([sw - win_w - 1, sh - win_h - 1], device=dev)

        pt = guess.clone()
        last = torch.zeros_like(pt)
        active = good.clone()
        stayed_in = torch.ones_like(active)
        for j in range(lk.max_iters):
            qj = pt - half
            iqj = torch.floor(qj)
            gj = qj - iqj
            iqji = iqj.to(torch.int64)
            inside = ((iqji >= lo) & (iqji < size)).all(-1)
            off = (iqji + pad - s_lo).clamp(min=0)
            off = torch.minimum(off, s_max)
            cj = s_lo + off
            jw = _bilinear(_window(planes[3], b, cj[:, 1], cj[:, 0],
                                   win_h + 1, win_w + 1), gj[:, 0], gj[:, 1])
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
# flow lines, cross points, the VP
# ---------------------------------------------------------------------------

def flow_lines(start, stop):
    """(length rounded to 2 decimals, angle in degrees [0, 360), moving)."""
    vx = stop[..., 0] - start[..., 0]
    vy = start[..., 1] - stop[..., 1]
    norm = torch.sqrt(vx * vx + vy * vy)
    length = torch.round(norm * 100) / 100
    cos = torch.where(norm > 0, vx / torch.where(norm > 0, norm, 1.0), 1.0)
    ang = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
    angle = torch.where(vy < 0, 360 - ang, ang)
    return length, angle, (vx != 0) | (vy != 0)


def cross_points(start, stop, pi, pj):
    """(B, P, 2) intersections of the pairs' lines: line 1 is the pair's
    second line j, line 2 its first i; slope-intercept form, x = x3 where
    line 2 is vertical, nan where the slopes are equal."""
    x1, y1 = start[:, pj, 0], start[:, pj, 1]
    x2, y2 = stop[:, pj, 0], stop[:, pj, 1]
    x3, y3 = start[:, pi, 0], start[:, pi, 1]
    x4, y4 = stop[:, pi, 0], stop[:, pi, 1]
    k1 = (y2 - y1) / (x2 - x1)
    b1 = y1 - x1 * k1
    vert = x4 == x3
    k2 = torch.where(vert, 0.0, (y4 - y3) / torch.where(vert, 1.0, x4 - x3))
    b2 = torch.where(vert, 0.0, y3 - x3 * k2)
    par = k1 == k2
    x = torch.where(vert, x3, torch.where(par, math.nan,
                                          (b2 - b1) / torch.where(par, 1.0,
                                                                  k1 - k2)))
    y = torch.where(~vert & par, math.nan, k1 * x + b1)
    return torch.stack([x, y], -1)


def _ring_put(ring, count, value, do):
    """ring[b, count[b] % R] = value[b] where do[b]."""
    r = ring.shape[1]
    hit = (torch.arange(r, device=ring.device) == (count % r)[:, None]) \
        & do[:, None]
    return torch.where(hit[..., None], value[:, None], ring)


def _ring_index(count, r):
    """(B, R): the append index each ring slot holds (-1 for none)."""
    k = torch.arange(r, device=count.device)
    c = count[:, None]
    idx = c - 1 - torch.remainder(c - 1 - k, r)
    return torch.where((idx >= 0) & (c > 0), idx, -1)


def vp_scan(vp: dict, cps, cand, cfg: Config):
    """The VP updates of one frame over its candidate cross points (B, P)
    in pair order; returns (vp state, accepted count (B,), update count
    (B,), rows): ``rows`` holds, per scanned position (B, I, ...), the
    accepted cross point ``cp_rows`` where ``cp_ok`` and the VP after the
    update ``upd_rows`` where ``upd_ok``, in scan order."""
    dev, dt = cps.device, cps.dtype
    bound = torch.tensor([cfg.width * cfg.cp_thold,
                          cfg.height * cfg.cp_thold], dtype=dt, device=dev)
    r = cfg.vp_ref_num
    v = dict(vp)
    n_acc = torch.zeros(cand.shape[0], dtype=torch.int64, device=dev)
    n_upd = torch.zeros_like(n_acc)
    order = torch.argsort((~cand).to(torch.uint8), dim=1, stable=True)
    cps = cps.gather(1, order[..., None].expand_as(cps))
    cand = cand.gather(1, order)
    seq = dict(cp_rows=[], cp_ok=[], upd_rows=[], upd_ok=[])
    for i in range(int(cand.sum(1).max().item()) if cand.numel() else 0):
        cp, ok = cps[:, i], cand[:, i]
        xy, init = v["vp_xy"], v["vp_init"]
        near = ((xy - cp).abs() < bound).all(-1)
        take = ok & (~init | near)
        ring = _ring_put(v["ring_xy"], v["ring_total"], cp, take)
        total = v["ring_total"] + take.to(torch.int64)
        idx = _ring_index(total, r)
        held = idx >= 0
        vals = torch.where(((idx == v["alias_pos"][:, None])
                            & (v["alias_pos"][:, None] >= 0))[..., None],
                           xy[:, None], ring)
        wgt = held[..., None].to(dt)
        m = held.sum(1).clamp(min=1)[:, None].to(dt)
        d = vals - xy[:, None]
        mean = (d * wgt).sum(1) / m
        std = torch.sqrt((((d - mean[:, None]) ** 2) * wgt).sum(1) / m)
        kept = held & (d <= (mean + std * cfg.max_cp_std)[:, None]).all(-1) \
            & (d >= (mean - std * cfg.max_cp_std)[:, None]).all(-1)
        c = kept.sum(1)
        move = (d * kept[..., None].to(dt)).sum(1) / c.clamp(min=1)[:, None]
        upd = take & init & (c > 0)
        start = take & ~init & (total >= r)
        new_xy = torch.where(upd[:, None], xy + move * cfg.vp_update_rate,
                             torch.where(start[:, None], ring.sum(1) / r, xy))
        alias = total - 1 if cfg.vp_init_aliasing \
            else torch.full_like(total, -1)
        v = dict(
            vp_xy=new_xy, vp_init=init | start,
            vp_moved=v["vp_moved"] | upd, ring_xy=ring, ring_total=total,
            alias_pos=torch.where(start, alias, v["alias_pos"]),
            vp_ult=torch.where(upd | start, 0, v["vp_ult"]),
            hist_xy=_ring_put(v["hist_xy"], v["hist_total"], new_xy, upd),
            hist_total=v["hist_total"] + upd.to(torch.int64))
        n_acc += take
        n_upd += upd
        for k, x in (("cp_rows", cp), ("cp_ok", take), ("upd_rows", new_xy),
                     ("upd_ok", upd)):
            seq[k].append(x)
    b = cand.shape[0]
    rows = {k: (torch.stack(x, 1) if x else
                torch.zeros((b, 0, 2) if k.endswith("rows") else (b, 0),
                            dtype=dt if k.endswith("rows") else torch.bool,
                            device=dev))
            for k, x in seq.items()}
    return v, n_acc, n_upd, rows


def show_step(v: dict, cfg: Config):
    """The per-frame show/hide block; returns (state, shown (B,)).  A shown
    frame's row is the VP before the block (``v["vp_xy"]``)."""
    hide = v["vp_init"] & (v["vp_ult"] > cfg.hide_vp_thold)
    show = v["vp_init"] & ~hide
    return dict(
        vp_xy=torch.where(hide[:, None], 0.0, v["vp_xy"]),
        vp_init=v["vp_init"] & ~hide, vp_moved=v["vp_moved"] & ~hide,
        ring_xy=v["ring_xy"], ring_total=torch.where(hide, 0, v["ring_total"]),
        alias_pos=torch.where(hide, -1, v["alias_pos"]),
        vp_ult=v["vp_ult"] + 1,
        hist_xy=_ring_put(v["hist_xy"], v["hist_total"], v["vp_xy"], show),
        hist_total=v["hist_total"] + show.to(torch.int64)), show


# ---------------------------------------------------------------------------
# Shi-Tomasi corners
# ---------------------------------------------------------------------------

def corners(gray, geom: Geometry, cfg: Config):
    """Each group's corner slots of (B, H, W) frames: ((B, G, S, 2) xy,
    (B, G, S) valid)."""
    fc = cfg.features
    y0, y1, x0, x1 = geom.crop
    img = gray[:, y0:y1, x0:x1]
    ix, iy = derivatives(img, SOBEL)
    k = fc.block_size

    def box(x):
        return _correlate(_correlate(x, (1.0,) * k, -1), (1.0,) * k, -2)

    a, bb, c = box(ix * ix) / 2, box(ix * iy), box(iy * iy) / 2
    resp = (a + c) - torch.sqrt((a - c) ** 2 + bb * bb)
    resp = torch.where(geom.subs[None], resp[:, None], 0.0)   # (B, 4, h, w)
    bsz, nm, h, w = resp.shape
    peak = F.max_pool2d(F.pad(resp.reshape(-1, 1, h, w), (1, 1, 1, 1),
                              value=-math.inf), 3, stride=1)
    peak = peak.reshape(resp.shape)
    top = resp.amax((-2, -1), keepdim=True)
    cand = torch.where((resp >= peak) & (resp > top * fc.quality_level)
                       & (resp > 0), resp, 0.0).reshape(bsz, nm, -1)
    yy = torch.arange(h, device=gray.device).repeat_interleave(w)
    xx = torch.arange(w, device=gray.device).repeat(h)
    xy, ok = [], []
    for _ in range(fc.max_corners):
        at = cand.argmax(-1)               # the first maximum in row order
        take = cand.gather(-1, at[..., None])[..., 0] > 0
        px, py = xx[at], yy[at]
        xy.append(torch.where(take[..., None],
                              torch.stack([px + x0, py + y0], -1), 0))
        ok.append(take)
        near = ((xx - px[..., None]) ** 2 + (yy - py[..., None]) ** 2
                < fc.min_distance ** 2)
        cand = torch.where(take[..., None] & near, 0.0, cand)
    xy = torch.stack(xy, 2).to(gray.dtype)     # (B, 4, C, 2)
    ok = torch.stack(ok, 2)
    g, s = cfg.num_groups, cfg.slots
    xy = xy.reshape(bsz, g, -1, 2)
    ok = ok.reshape(bsz, g, -1)
    order = torch.argsort((~ok).to(torch.uint8), dim=-1, stable=True)[..., :s]
    ok = ok.gather(-1, order)
    xy = xy.gather(-2, order[..., None].expand(order.shape + (2,)))
    return torch.where(ok[..., None], xy, 0.0), ok


def initial_state(first_u8, cfg: Config, geom: Geometry,
                  low_precision: bool = False) -> dict:
    """The state a stream starts from on its first staged u8 frame
    (B, H, W): the finished frame as ``prev_gray``, its Shi-Tomasi corners
    in the slots, ``min_fl_len`` as every group's average length, and a VP
    state with nothing in it (no VP, empty rings, no alias)."""
    dt = torch.float32 if low_precision else torch.float64
    gray = finish(first_u8, dt, low_precision)
    pts, ok = corners(gray, geom, cfg)
    b, dev = first_u8.shape[0], first_u8.device

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


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

def step(prev_u8, next_u8, state: dict, cfg: Config, geom: Geometry,
         low_precision: bool = False) -> dict:
    """One step of B streams from ``state`` (the program's state before
    frame t: ``pts``, ``valid``, ``avg_len``, ``tp_ult`` and the VP state's
    fields under ``vp``) with the staged u8 frames t - 1 and t (B, H, W).

    Returns the tracked points ``pts`` (B, G*S, 2) and ``surv`` (B, G*S),
    the accepted cross points ``n_cp`` and VP updates ``n_upd`` (B,), the
    VP after the frame ``vp_xy`` (B, 2) and ``vp_init`` (B,), the
    replenish trigger ``trigger`` and its taking ``replenish`` (B,), the
    next state's slots ``next_pts`` (B, G, S, 2), ``next_valid``, and the
    frame's rows (``vp_scan``'s, with ``show_row`` (B, 2) where ``shown``
    (B,)), which ``frame_rows`` turns into what the sinks receive."""
    dt = torch.float32 if low_precision else torch.float64
    g, s = cfg.num_groups, cfg.slots
    frames = finish(torch.stack([prev_u8, next_u8]), dt, low_precision)
    levels = [frames]
    for _ in range(cfg.lk.max_level):
        levels.append(pyr_down(levels[-1]))
    bsz = prev_u8.shape[0]
    p0 = state["pts"].to(dt).reshape(bsz, g * s, 2)
    p1, st = track([lv[0] for lv in levels], [lv[1] for lv in levels], p0,
                   state["valid"].reshape(bsz, g * s), cfg.lk)

    # check_inside
    xi = torch.floor(p1[..., 0]).to(torch.int64)
    yi = torch.floor(p1[..., 1]).to(torch.int64)
    inb = (xi >= 0) & (xi < cfg.width) & (yi >= 0) & (yi < cfg.height)
    surv = st & inb & geom.roi[yi.clamp(0, cfg.height - 1),
                               xi.clamp(0, cfg.width - 1)]

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


def frame_rows(out: dict, csv_rows_on_update: bool = True) -> list:
    """Per stream of a ``step``'s result, the rows its sink receives for
    the frame, float64 numpy (n, 2): ``cp`` the accepted cross points,
    ``csv`` the VP after each update then the shown VP (the vps csv rows,
    LK_Final.py:612-614,637-638; the shown VP alone without
    ``csv_rows_on_update``), ``shown`` the shown VP or nothing."""
    host = {k: out[k].detach().to("cpu", torch.float64).numpy()
            if out[k].is_floating_point() else out[k].cpu().numpy()
            for k in ("cp_rows", "cp_ok", "upd_rows", "upd_ok", "show_row",
                      "shown")}
    rows = []
    for b in range(host["shown"].shape[0]):
        shown = host["show_row"][b][None][:int(host["shown"][b])]
        upd = host["upd_rows"][b][host["upd_ok"][b]]
        rows.append(dict(
            cp=host["cp_rows"][b][host["cp_ok"][b]],
            csv=np.concatenate([upd, shown]) if csv_rows_on_update
            else shown, shown=shown))
    return rows


# ---------------------------------------------------------------------------
# the compared numbers
# ---------------------------------------------------------------------------

# a tracked point this far from the reference's is a mismatched slot
FLIP_PX = 0.01
# a VP, or a row a sink received, this far from the reference's is off
OFF_PX = 0.05


def _seed_fields(state: dict) -> dict:
    """The fields of a seeded state other than its slots, float64."""
    flat = dict(prev_gray=state["prev_gray"], avg_len=state["avg_len"],
                tp_ult=state["tp_ult"], **state["vp"])
    return {k: v.to(torch.float64) for k, v in flat.items()}


class Tally:
    """The check's numbers over many steps of the program (``got``, the
    program's step or the control) against the reference (``want``), each
    the dict ``step`` returns:

    * ``pts_gap_px``, ``pts_mean_gap_px``: the 99.9th percentile and the
      mean of the distances of the tracked points valid on both sides.
      Rounding alone leaves some 1e-5 px; a point whose iterations stop one
      step apart on the two sides (the eps test or the half-step rule taken
      the other way, at some level) lands up to ~0.005 px away, about one
      point in 30,000: the percentile reads the rounding, the mean all;
    * ``slot_mismatch_share``: of every tracked slot, every replenished
      slot where either side replenished, and every slot a stream was
      seeded with (``add_seed``), the share that differ: validity on
      either, a tracked point more than ``FLIP_PX`` away (no rounding and
      no stop taken the other way moves it so far), or a detected corner
      (integers on both sides: equal, or not);
    * ``row_count_mismatch_share``: stream-steps whose accepted cross points
      or VP updates differ in number;
    * ``vp_gap_px``: the median distance of the VPs over the steps where
      both hold one (a VP update's mean +- std clip can keep another cross
      point on the two sides and move one VP by up to a pixel, on a few
      steps in a thousand: the median reads the rounding, not those);
    * ``vp_off_share``: the share of those VPs more than ``OFF_PX`` away,
      which the clip's rare flips stay under and a fault on a few streams
      does not;
    * ``drained_row_off_share``: of the rows the sinks received (cross
      points, csv rows and shown VPs, frame by frame, as ``frame_rows``
      gives the reference's), the share more than ``OFF_PX`` from the
      reference's row at the same place; every row of a frame whose row
      counts differ, or of a stream whose drained rows do not add up to
      the chunk's counts (``None``), is off;
    * ``drain_mismatch``: added by the driver (stream-frames whose drained
      rows are not the frame's uncompacted outputs bit for bit);
    * ``seed_state_mismatch``: seeded streams whose state besides its slots
      (the finished first frame, the average lengths, the replenish
      counter, the empty VP state) is not the reference's exactly;
    * the coverage guards of the reference's steps: ``no_vp_share``, the
      share of steps with no VP, and ``no_replenish``, 1 when no step
      replenished;
    * ``replay_mismatch``: added by the driver (leaves of the replayed
      chunks' outputs and end states that differ from the timed run's)."""

    def __init__(self, csv_rows_on_update: bool = True):
        self.csv_rows_on_update = csv_rows_on_update
        self.replay_mismatch = 0
        self.gaps = []
        self.slots = 0
        self.slots_bad = 0
        self.steps = 0
        self.rows_bad = 0
        self.vp_gaps = []
        self.no_vp = 0
        self.replenished = 0
        self.drain_mismatch = 0
        self.drained = 0
        self.drained_off = 0
        self.seed_bad = 0

    def add(self, got: dict, want: dict) -> None:
        both = got["surv"] & want["surv"]
        gap = (got["pts"].to(torch.float64)
               - want["pts"].to(torch.float64)).norm(dim=-1)[both]
        self.gaps.append(gap)
        bad = int((got["surv"] != want["surv"]).sum()
                  + (gap > FLIP_PX).sum())
        slots = got["surv"].numel()
        rep_g, rep_w = got["replenish"], want["replenish"]
        either = rep_g | rep_w
        if bool(either.any()):
            per = got["next_valid"][0].numel()
            slots += per * int(either.sum())
            bad += per * int((rep_g != rep_w).sum())
            sure = rep_g & rep_w
            bad += self._slots_differ(got["next_pts"][sure],
                                      got["next_valid"][sure],
                                      want["next_pts"][sure],
                                      want["next_valid"][sure])
        self.slots += slots
        self.slots_bad += bad
        self.steps += got["surv"].shape[0]
        self.rows_bad += int(((got["n_cp"] != want["n_cp"])
                              | (got["n_upd"] != want["n_upd"])).sum())
        vp = got["vp_init"] & want["vp_init"]
        if bool(vp.any()):
            d = (got["vp_xy"].to(torch.float64)
                 - want["vp_xy"].to(torch.float64)).norm(dim=-1)[vp]
            self.vp_gaps.append(d)
        self.no_vp += int((~want["vp_init"]).sum())
        self.replenished += int(rep_w.sum())
        got_rows = got["rows"] if "rows" in got else frame_rows(
            got, self.csv_rows_on_update)
        self._add_rows(got_rows, frame_rows(want, self.csv_rows_on_update))

    @staticmethod
    def _slots_differ(xy_g, nv_g, xy_w, nv_w) -> int:
        """Slots whose validity or detected corner differs."""
        xy_g, xy_w = xy_g.to(torch.float64), xy_w.to(torch.float64)
        return int(((nv_g != nv_w) | (nv_g & (xy_g != xy_w).any(-1))).sum())

    def _add_rows(self, got_rows: list, want_rows: list) -> None:
        for g, w in zip(got_rows, want_rows):
            for key, rw in w.items():
                rg = None if g is None else g[key]
                if rg is None or rg.shape != rw.shape:
                    n = max(len(rw), 0 if rg is None else len(rg), 1)
                    self.drained += n
                    self.drained_off += n
                    continue
                self.drained += len(rw)
                self.drained_off += int(
                    (np.linalg.norm(rg - rw, axis=-1) > OFF_PX).sum())

    def add_seed(self, got: dict, want: dict) -> None:
        """A seeded state of B streams (``initial_state``'s fields) against
        the reference's."""
        self.slots += got["valid"].numel()
        self.slots_bad += self._slots_differ(got["pts"], got["valid"],
                                             want["pts"], want["valid"])
        g, w = _seed_fields(got), _seed_fields(want)
        bad = torch.zeros(got["valid"].shape[0], dtype=torch.bool,
                          device=got["valid"].device)
        for k, x in w.items():
            bad |= (g[k] != x).reshape(x.shape[0], -1).any(1)
        self.seed_bad += int(bad.sum())

    def numbers(self) -> dict:
        gaps = torch.cat([g.cpu() for g in self.gaps]
                         + [torch.zeros(0, dtype=torch.float64)])
        if not gaps.numel():
            gaps = torch.zeros(1, dtype=torch.float64)
        vp = (torch.cat([d.cpu() for d in self.vp_gaps]) if self.vp_gaps
              else torch.zeros(1, dtype=torch.float64))
        return dict(
            replay_mismatch=float(self.replay_mismatch),
            pts_gap_px=float(torch.quantile(gaps, 0.999)),
            pts_mean_gap_px=float(gaps.mean()),
            slot_mismatch_share=self.slots_bad / max(self.slots, 1),
            row_count_mismatch_share=self.rows_bad / max(self.steps, 1),
            vp_gap_px=float(vp.median()),
            vp_off_share=float((vp > OFF_PX).double().mean()),
            drained_row_off_share=self.drained_off / max(self.drained, 1),
            drain_mismatch=float(self.drain_mismatch),
            seed_state_mismatch=float(self.seed_bad),
            no_vp_share=self.no_vp / max(self.steps, 1),
            no_replenish=float(self.replenished == 0))
