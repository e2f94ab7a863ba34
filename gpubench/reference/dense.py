"""The plain reference of the dense cells: one pair's pyramidal LK flow,
written from the semantics that ``lk_tpu`` states for its production dense
path, in float64.

What it computes, for the configuration file's ``lk`` and ``dense`` values
(the grads-fused path: ``use_pallas_warp``, ``fused_grads_in_kernel``,
``fused_coarse_chain``, ``pallas_pyramid``):

* Depth: ``pyramid_levels``, less while the top level would be narrower or
  shorter than the window.
* Base: the frames edge-padded at the bottom and right to the finest
  level's tile geometry when every level then halves exactly and runs
  pad-free (1080x1920 -> 1088x2048); each level is ``cv.pyrDown`` of the
  one below (5-tap binomial, BORDER_REFLECT_101, even samples).
* Each level, from the top down, runs ``level_iters`` Jacobi iterations
  of the inverse-compositional solve over tiles (the top level is one
  tile).  Scharr gradients of the edge-replicated ``prev``; 15x15 box
  sums; the gate ``min_eig >= min_eig_threshold * 1024`` and ``det > 1e-7``.
  The warp of ``next`` is separable (a two-tap tent down the rows, then
  along the columns) around the tile's reference displacement (the flow at
  the tile centre, rounded half to even), with the residual clamped to
  ``+-local`` of it and the sample clamped to the level.  The flow on a
  tile's 8-pixel halo is the current flow inside the level and the initial
  flow outside it.
* Between levels the flow is doubled and upsampled with the 0.25/0.75 taps
  of ``upsample2_linear``; a coarse-chain level evaluates those taps on its
  halo too (coarse indices clamped), and takes its tile's reference
  displacement from the coarse plane's dominant tap.
* The outputs are cropped to the frame: flow (H, W, 2), ``min_eig``
  (H, W) per window area, ``valid`` (H, W) bool.

Nothing here is taken from the program: the frames are the harness's, and
every pyramid, gradient and flow is worked out again.  With
``low_precision`` the frames are rounded to bfloat16 and the arithmetic is
float32: the control, the step below the configuration's float32 that
storing frames or pyramids in half the bytes would take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HALO = 8                       # halo rows/cols around a tile
GAUSS5 = (1.0, 4.0, 6.0, 4.0, 1.0)
MIN_EIG_SCALE = 1024.0         # OpenCV's fixed-point gradient scale


def _ceil(a: int, m: int) -> int:
    return -(-a // m) * m


def _sched(seq, level: int):
    return seq[min(level, len(seq) - 1)]


def pick_tile_w(w: int) -> tuple[int, int]:
    """(tile_w, padded_w): one tile up to 512 wide, else the least padding
    over 512/384/256/128, the widest first among equals."""
    if w <= 512:
        return w, w
    best = None
    for tw in (512, 384, 256, 128):
        waste = _ceil(w, tw) - w
        if best is None or waste < best[0]:
            best = (waste, tw)
    return best[1], _ceil(w, best[1])


def level_geometry(h: int, w: int, resident_max_h: int):
    """(resident, tile_h, tile_w, padded_h, padded_w) of a grads-fused level."""
    hc = _ceil(h, 8)
    resident = hc <= min(resident_max_h, 272) and w <= 512
    if resident:
        th = hc
    else:
        cands = [min(hc, t) for t in (272, 136, 64)]
        least = min(_ceil(h, t) for t in cands)
        th = next(t for t in cands if _ceil(h, t) == least)
    tw, wp = pick_tile_w(w)
    if not resident and w > 512:
        for cand in (512, 384, 256):
            if cand <= tw:
                break
            if _ceil(w, cand) - w <= (wp - w) + 128:
                tw, wp = cand, _ceil(w, cand)
                break
    return resident, th, tw, _ceil(h, th), wp


class Plan:
    """The static choices of one frame size: depth, base, level geometry."""

    def __init__(self, h: int, w: int, lk: dict, dense: dict):
        for key, want in (("use_pallas_warp", True),
                          ("fused_grads_in_kernel", True),
                          ("fused_coarse_chain", True),
                          ("pallas_pyramid", True),
                          ("video_warm_start", False),
                          ("bf16_box_sums", False),
                          ("bf16_warp_window", False),
                          ("fused_tile_h", 0), ("fused_tile_w", 0)):
            if dense[key] != want:
                raise ValueError(f"the reference implements {key}={want}")
        win_w, win_h = lk["win_size"]
        if win_w != win_h:
            raise ValueError("the reference implements square windows")
        self.win = win_h
        self.dense = dense
        self.thr = lk["min_eig_threshold"] * MIN_EIG_SCALE
        top = dense["pyramid_levels"] - 1
        while top > 0 and ((h >> top) < win_h or (w >> top) < win_w):
            top -= 1
        self.top = top
        self.true_hw = (h, w)
        self.base = self._base(h, w)
        self.sizes = [self.base]
        for _ in range(top):
            ph, pw = self.sizes[-1]
            self.sizes.append(((ph + 1) // 2, (pw + 1) // 2))
        self.geom = [level_geometry(*self.sizes[lv], self._resident_max(lv))
                     for lv in range(top + 1)]
        self.coarse = [self._coarse_ok(lv) for lv in range(top + 1)]

    def iters(self, lv):
        return _sched(self.dense["iter_schedule"], lv)

    def local(self, lv):
        return _sched(self.dense["warp_local_schedule"], lv)

    def disp(self, lv):
        return max(4, self.dense["max_disp"] >> lv)

    def _resident_max(self, lv):
        return self.dense["fused_resident_max_h"] if lv == self.top else 0

    def _base(self, h, w):
        if self.top == 0:
            return h, w
        _, _, _, hp, wp = level_geometry(h, w, 0)
        hp = _ceil(hp, 16)
        if (hp, wp) == (h, w) or self._padded_plan_holds(hp, wp):
            return hp, wp
        return h, w

    def _padded_plan_holds(self, h, w):
        hs, ws = [h], [w]
        for _ in range(self.top):
            if hs[-1] % 2 or ws[-1] % 2:
                return False
            hs.append(hs[-1] // 2)
            ws.append(ws[-1] // 2)
        for lv in range(self.top + 1):
            res, th, tw, hp, wp = level_geometry(hs[lv], ws[lv],
                                                 self._resident_max(lv))
            if (hp, wp) != (hs[lv], ws[lv]):
                return False
            if lv == self.top:
                if not res:
                    return False
            elif res or self.iters(lv) != 1 or th % 16 or tw % 256:
                return False
        return True

    def _coarse_ok(self, lv):
        if lv == self.top or self.iters(lv) != 1:
            return False
        h, w = self.sizes[lv]
        if self.sizes[lv + 1] != (h // 2, w // 2):
            return False
        res, th, tw, hp, wp = self.geom[lv]
        return (not res and (hp, wp) == (h, w) and th % 16 == 0
                and tw % 256 == 0)


def _grid(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """img on the grid of integer rows ys x columns xs (1-D), indices
    clamped: edge replication."""
    h, w = img.shape
    return img[ys.clamp(0, h - 1)[:, None], xs.clamp(0, w - 1)[None, :]]


def _span(a: int, b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(a, b, device=like.device)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv.pyrDown: 5-tap binomial, BORDER_REFLECT_101, even samples."""
    taps = torch.tensor(GAUSS5, dtype=img.dtype, device=img.device) / 16.0
    x = F.pad(img[None, None], (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, taps.view(1, 1, 5, 1))
    x = F.conv2d(x, taps.view(1, 1, 1, 5))
    return x[0, 0, ::2, ::2]


def _box(q: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sums of every full window of q."""
    return F.avg_pool2d(q[None, None], k, stride=1)[0, 0] * (k * k)


def _scharr(prev: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """(ix, iy) of edge-replicated ``prev`` on the grid ys x xs: [3,10,3]/16
    smoothing across, [-1,0,1]/2 along."""
    p = _grid(prev, _span(int(ys[0]) - 1, int(ys[-1]) + 2, ys),
              _span(int(xs[0]) - 1, int(xs[-1]) + 2, xs))
    sy = (3 * p[:-2] + 10 * p[1:-1] + 3 * p[2:]) / 16.0
    sx = (3 * p[:, :-2] + 10 * p[:, 1:-1] + 3 * p[:, 2:]) / 16.0
    return (sy[:, 2:] - sy[:, :-2]) * 0.5, (sx[2:] - sx[:-2]) * 0.5


def _up_taps(coarse: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """2 x upsample2_linear of one coarse plane on the fine grid ys x xs,
    any integers: even i reads 0.25 c[i/2-1] + 0.75 c[i/2], odd i 0.75
    c[(i-1)/2] + 0.25 c[(i+1)/2], coarse indices clamped."""

    def axis(i):
        k = torch.div(i, 2, rounding_mode="floor")
        odd = (i - 2 * k) == 1
        return (torch.where(odd, k, k - 1),
                torch.where(odd, 0.75, 0.25).to(coarse.dtype))

    ly, wy = axis(ys)
    lx, wx = axis(xs)
    wy, wx = wy[:, None], wx[None, :]
    lo = wx * _grid(coarse, ly, lx) + (1 - wx) * _grid(coarse, ly, lx + 1)
    hi = (wx * _grid(coarse, ly + 1, lx)
          + (1 - wx) * _grid(coarse, ly + 1, lx + 1))
    return 2.0 * (wy * lo + (1 - wy) * hi)


def _tent(win: torch.Tensor, rel: torch.Tensor, dim: int, n: int):
    """out[i] = (1 - f) win[i + d] + f win[i + d + 1], d = floor(rel),
    f = rel - d, along ``dim`` (n outputs)."""
    d = torch.floor(rel)
    f = rel - d
    d = d.long()
    if dim == 0:
        base = _span(0, n, win)[:, None] + d
        cols = _span(0, win.shape[1], win)[None, :]
        t0, t1 = win[base, cols], win[base + 1, cols]
    else:
        base = _span(0, n, win)[None, :] + d
        rows = _span(0, win.shape[0], win)[:, None]
        t0, t1 = win[rows, base], win[rows, base + 1]
    return (1 - f) * t0 + f * t1


def _warp(nxt, fx, fy, ye, xe, ref, bound, local):
    """The warped ``nxt`` on one tile's extended region (rows ye, cols xe)."""
    hp, wp = nxt.shape
    dy0 = torch.round(ref[1].clamp(-bound, bound))
    dx0 = torch.round(ref[0].clamp(-bound, bound))
    gy0 = ye.to(fx.dtype)[:, None]
    gx0 = xe.to(fx.dtype)[None, :]
    gy = (gy0 + fy.clamp(-bound, bound)).clamp(0, hp - 1)
    gx = (gx0 + fx.clamp(-bound, bound)).clamp(0, wp - 1)
    rel_y = (gy - gy0 - dy0 + local).clamp(0, 2 * local)
    rel_x = (gx - gx0 - dx0 + local).clamp(0, 2 * local)
    eh, ew = fx.shape
    y_org = int(ye[0]) + int(dy0) - local
    x_org = int(xe[0]) + int(dx0) - local
    win = _grid(nxt, _span(y_org, y_org + eh + 2 * local + 2, nxt),
                _span(x_org, x_org + ew + 2 * local + 2, nxt))
    # the rows' shift of window column j is that of region column j (the
    # last region column's beyond the region)
    rel_y_cols = torch.cat(
        [rel_y, rel_y[:, -1:].expand(eh, 2 * local + 2)], dim=1)
    vert = _tent(win, rel_y_cols, 0, eh)
    return _tent(vert, rel_x, 1, ew)


def _level(prev, nxt, plan: Plan, lv: int, init_at, coarse):
    """One level: Jacobi iterations over tiles.  ``init_at(ys, xs)`` is the
    initial flow (2, len(ys), len(xs)) on any integer grid; ``coarse`` the
    coarser level's flow planes on a coarse-chain level, else None."""
    _, th, tw, hp, wp = plan.geom[lv]
    h0, w0 = prev.shape
    if (hp, wp) != (h0, w0):
        prev = _grid(prev, _span(0, hp, prev), _span(0, wp, prev))
        nxt = _grid(nxt, _span(0, hp, nxt), _span(0, wp, nxt))
    bound = float(plan.disp(lv))
    local = plan.local(lv)
    k = plan.win
    c = HALO - k // 2           # a window's first row/col in a halo'd grid

    # the structure tensor and its gate, once per level
    ix_all, iy_all = _scharr(prev, _span(-HALO, hp + HALO, prev),
                             _span(-HALO, wp + HALO, prev))
    a11 = _box(ix_all * ix_all, k)[c:c + hp, c:c + wp]
    a12 = _box(ix_all * iy_all, k)[c:c + hp, c:c + wp]
    a22 = _box(iy_all * iy_all, k)[c:c + hp, c:c + wp]
    det = a11 * a22 - a12 * a12
    min_eig = (a11 + a22 - torch.sqrt((a11 - a22) ** 2 + 4 * a12 * a12)) / (
        2.0 * k * k)
    solvable = det > 1e-7
    valid = (min_eig >= plan.thr) & solvable
    invd = valid.to(prev.dtype) / torch.where(solvable, det,
                                              torch.ones_like(det))

    cur = init_at(_span(0, hp, prev), _span(0, wp, prev))
    for it in range(plan.iters(lv)):
        new = torch.empty_like(cur)
        for y0 in range(0, hp, th):
            for x0 in range(0, wp, tw):
                ye = _span(y0 - HALO, y0 + th + HALO, prev)
                xe = _span(x0 - HALO, x0 + tw + HALO, prev)
                inside = (((ye >= 0) & (ye < hp))[:, None]
                          & ((xe >= 0) & (xe < wp))[None, :])
                fl = torch.where(inside, torch.stack(
                    [_grid(cur[0], ye, xe), _grid(cur[1], ye, xe)]),
                    init_at(ye, xe))
                if coarse is not None and it == 0:
                    cy = y0 // 2 + (th // 2 + HALO + 1) // 2 - 4
                    cx = x0 // 2 + (tw // 2 + HALO + 1) // 2 - 4
                    ref = 2.0 * coarse[:, cy, cx]
                else:
                    ref = cur[:, y0 + th // 2, x0 + tw // 2]
                jw = _warp(nxt, fl[0], fl[1], ye, xe, ref, bound, local)
                ix = ix_all[y0:y0 + th + 2 * HALO, x0:x0 + tw + 2 * HALO]
                iy = iy_all[y0:y0 + th + 2 * HALO, x0:x0 + tw + 2 * HALO]
                r = jw - _grid(prev, ye, xe) - (ix * fl[0] + iy * fl[1])
                ty, tx = slice(y0, y0 + th), slice(x0, x0 + tw)
                fx = fl[0, HALO:HALO + th, HALO:HALO + tw]
                fy = fl[1, HALO:HALO + th, HALO:HALO + tw]
                b1 = (_box(ix * r, k)[c:c + th, c:c + tw]
                      + a11[ty, tx] * fx + a12[ty, tx] * fy)
                b2 = (_box(iy * r, k)[c:c + th, c:c + tw]
                      + a12[ty, tx] * fx + a22[ty, tx] * fy)
                du = (a12[ty, tx] * b2 - a22[ty, tx] * b1) * invd[ty, tx]
                dv = (a12[ty, tx] * b1 - a11[ty, tx] * b2) * invd[ty, tx]
                new[0, ty, tx] = (fx + du).clamp(-bound, bound)
                new[1, ty, tx] = (fy + dv).clamp(-bound, bound)
        cur = new
    return cur[:, :h0, :w0], min_eig[:h0, :w0], valid[:h0, :w0]


def _taps_of(coarse):
    """The initial flow of the level below ``coarse``: its upsample taps."""
    return lambda ys, xs: torch.stack([_up_taps(coarse[0], ys, xs),
                                       _up_taps(coarse[1], ys, xs)])


def pair_flow(prev: torch.Tensor, nxt: torch.Tensor, config: dict,
              low_precision: bool = False):
    """(flow (H, W, 2), min_eig (H, W), valid (H, W)) of one pair of
    (H, W) gray frames (0..255)."""
    if low_precision:
        dt = torch.float32
        prev, nxt = prev.to(torch.bfloat16), nxt.to(torch.bfloat16)
    else:
        dt = torch.float64
    h, w = prev.shape
    plan = Plan(h, w, config["lk"], config["dense"])
    with torch.no_grad():
        bh, bw = plan.base
        rows, cols = _span(0, bh, prev), _span(0, bw, prev)
        pyr = [(_grid(prev.to(dt), rows, cols), _grid(nxt.to(dt), rows, cols))]
        for _ in range(plan.top):
            pyr.append((pyr_down(pyr[-1][0]), pyr_down(pyr[-1][1])))

        flow = None
        for lv in range(plan.top, -1, -1):
            lp, ln = pyr[lv]
            coarse = None
            if lv == plan.top:
                def init_at(ys, xs):
                    return torch.zeros((2, ys.numel(), xs.numel()),
                                       dtype=dt, device=lp.device)
            elif plan.coarse[lv]:
                coarse = flow
                init_at = _taps_of(flow)
            else:
                up = _taps_of(flow)(_span(0, lp.shape[0], lp),
                                    _span(0, lp.shape[1], lp))

                def init_at(ys, xs, up=up):
                    return torch.stack([_grid(up[0], ys, xs),
                                        _grid(up[1], ys, xs)])
            flow, min_eig, valid = _level(lp, ln, plan, lv, init_at, coarse)
        return flow.permute(1, 2, 0)[:h, :w], min_eig[:h, :w], valid[:h, :w]


# Pixels this close to a frame edge that the base pads are left out of
# the widest gap (``interior``).  The pad's edge-replicated columns and rows
# hold systems whose min_eig sits on the gate, computed in float32 as a
# difference of nearly equal terms; one flips there on about one pair in
# a hundred, and its flow reaches some 100 px into the frame, under 5e-4 px
# from 64 px on.  The mean gap still covers every pixel.
EDGE_BAND = 64


def interior(h: int, w: int, config: dict) -> tuple[int, int]:
    """(rows, cols) of the region whose widest gap is compared: the frame
    less ``EDGE_BAND`` pixels at each edge the base pads."""
    bh, bw = Plan(h, w, config["lk"], config["dense"]).base
    return (h - EDGE_BAND if bh > h else h), (w - EDGE_BAND if bw > w else w)


def gaps(got, want, config: dict) -> dict:
    """The numbers compared for one pair: the largest flow difference in
    px over the interior, the mean end-point difference in px over the
    whole frame, and the largest min_eig difference over the reference's
    largest min_eig.  ``valid`` (min_eig's gate) is checked for its shape
    and type: a flag that differs moves that pixel's flow."""
    flow, eig, valid = got
    rflow, reig, rvalid = want
    if valid.shape != rvalid.shape or valid.dtype != rvalid.dtype:
        raise ValueError(f"valid {tuple(valid.shape)} {valid.dtype}, the "
                         f"reference's {tuple(rvalid.shape)} {rvalid.dtype}")
    diff = flow.double() - rflow.double()
    reig = reig.double()
    rows, cols = interior(*rvalid.shape, config)
    return {
        "flow_gap_px": float(diff[:rows, :cols].abs().max()),
        "flow_mean_gap_px": float(diff.norm(dim=-1).mean()),
        "min_eig_gap": float((eig.double() - reig).abs().max()
                             / reig.abs().max().clamp_min(1e-30)),
    }
