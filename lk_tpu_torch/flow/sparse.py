"""The sparse pyramidal Lucas–Kanade trackers (PyTorch port).

Counterpart of ``lk_tpu/flow/sparse.py``: the per-point tracker
(``build_tracking_pyramid``, ``_sample_patch``, ``_track_one_level``,
``_track_one``, ``track_points``) and the batched tracker
(``_level_row_bands``, ``fold_tracking_levels``, ``track_points_batched``
and ``track_points_batched_prepped``), with OpenCV's semantics as there
(Scharr gradients of the previous frame sampled with the window's bilinear
weights, min-eig/area gate, <= max_iters Newton steps with the eps stop and
the oscillation half-step, status and err at level 0).

``track_points`` is the single-stream pipeline's tracker: every iteration
samples its window from the whole REFLECT_101-padded level at the clamped
corner (no superwindow: that is a deviation of the batched path only).  The
prev and next pyramids come from one ``build_pyramid`` call on the stacked
pair (one pyramid-kernel launch on the card).

The batched tracker's window gather is ``gather_windows``, the counterpart
of ``_gather_windows_pallas``: a CUDA tensor goes to the kernel
``lk_tpu_torch/csrc/window_gather.cu``, a CPU tensor to
``gather_windows_reference`` (full-frame Scharr of the folded level, then
index gathers — the JAX package's ``pallas_windows=False`` path).  The two
agree bit for bit.  ``LKConfig.pallas_windows`` and ``fast_pyramid`` are
accepted and ignored: the pyramid is always the exact f32 pyrDown of
``build_pyramid`` (one kernel launch per fold on the card).

Translation notes:

* ``vmap`` over points is the leading point axis, ``lax.while_loop`` over
  ``any(active)`` runs exactly ``cfg.max_iters`` masked iterations with no
  host sync.  That is the same function: once every point is inactive an
  iteration changes nothing (its step, ``inside_ok`` and ``active`` are all
  masked by ``active``), and the iteration count only feeds ``osc``: a
  point still active at iteration j has been active since iteration 0, so
  its own count is j.
* ``sample_next``'s shift-select sum over every offset is a TPU workaround;
  here it is a direct gather of the two taps per axis, ``(1-g)*a + g*b``:
  the other terms of the TPU form are exact zeros added in ascending order,
  so the two are the same arithmetic.
* ``jnp.pad(mode="reflect")`` reflects again where the pad reaches past
  the far edge (a coarse level of a small frame): ``reflect_index`` is
  that periodic reflection.

Functions run where their tensors are.
"""

from __future__ import annotations

import ctypes

import torch

from lk_tpu_torch.config import LKConfig
from lk_tpu_torch.ops.blur import (_device_cache, build_pyramid,
                                   reflect101_index)
from lk_tpu_torch.ops.gradients import scharr_derivatives
from lk_tpu_torch.utils.profiling import span

# superwindow of `next` fetched per point per level (lk_tpu's _SW_ROWS/COLS)
_SW_ROWS = 32
_SW_COLS = 48
# level rows kept beyond a tracker row band (lk_tpu's _BAND_MARGIN)
_BAND_MARGIN = 64

# Kernel launches of the CUDA gather, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


# ---------------------------------------------------------------------------
# window gather: kernel wrapper and plain version
# ---------------------------------------------------------------------------

def _check_gather(prev_f, next_f, cy, cx, sy, sx):
    if prev_f.ndim != 2 or next_f.shape != prev_f.shape:
        raise ValueError(f"folded levels must be (FH, FW): "
                         f"{tuple(prev_f.shape)} {tuple(next_f.shape)}")
    for name, t in (("prev", prev_f), ("next", next_f)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    n = cy.shape[0]
    for name, t in (("cy", cy), ("cx", cx), ("sy", sy), ("sx", sx)):
        if t.shape != (n,) or t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{name}: ({n},) integer corners expected, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (next_f, cy, cx, sy, sx):
        if t.device != prev_f.device:
            raise ValueError(f"gather inputs on {t.device} and "
                             f"{prev_f.device}")


def gather_windows(prev_f, next_f, cy, cx, sy, sx, win_h, win_w, sw_h, sw_w):
    """Per-point windows of the folded levels: ``raw`` (n, 3, win_h+1,
    win_w+1) — prev, Scharr ix, Scharr iy at corner (cy, cx) — and ``sw``
    (n, sw_h, sw_w), next at corner (sy, sx).  Corners clamp into the
    array as ``jax.lax.dynamic_slice`` clamps them."""
    if prev_f.device.type == "cpu":
        return gather_windows_reference(prev_f, next_f, cy, cx, sy, sx,
                                        win_h, win_w, sw_h, sw_w)
    if prev_f.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device "
                         f"{prev_f.device}")
    return _gather_windows_cuda(prev_f, next_f, cy, cx, sy, sx, win_h, win_w,
                                sw_h, sw_w)


def _crop_index(start, size, limit):
    """(n, size) row/col indices of dynamic_slice crops (start clamped)."""
    s = start.to(torch.int64).clamp(0, limit - size)
    return s[:, None] + torch.arange(size, device=start.device)


def gather_windows_reference(prev_f, next_f, cy, cx, sy, sx, win_h, win_w,
                             sw_h, sw_w):
    """Plain PyTorch form of ``gather_windows``."""
    global plain_calls
    _check_gather(prev_f, next_f, cy, cx, sy, sx)
    plain_calls += 1
    fh, fw = prev_f.shape
    ix, iy = scharr_derivatives(prev_f)
    stack3 = torch.stack([prev_f, ix, iy])
    rows = _crop_index(cy, win_h + 1, fh)
    cols = _crop_index(cx, win_w + 1, fw)
    raw = stack3[:, rows[:, :, None], cols[:, None, :]].transpose(0, 1)
    rows = _crop_index(sy, sw_h, fh)
    cols = _crop_index(sx, sw_w, fw)
    sw = next_f[rows[:, :, None], cols[:, None, :]]
    return raw.contiguous(), sw


def _gather_windows_cuda(prev_f, next_f, cy, cx, sy, sx, win_h, win_w, sw_h,
                         sw_w):
    global kernel_launches
    from lk_tpu_torch import _build

    _check_gather(prev_f, next_f, cy, cx, sy, sx)
    if not (prev_f.is_contiguous() and next_f.is_contiguous()):
        raise ValueError("gather_windows: folded levels must be contiguous")
    if (win_h + 3) * (win_w + 3) * 4 > 48 * 1024:
        raise ValueError(f"window {win_w}x{win_h} too large for the kernel")
    fh, fw = prev_f.shape
    if fh < max(win_h + 1, sw_h, 2) or fw < max(win_w + 1, sw_w, 2):
        raise ValueError(f"folded level {fh}x{fw} smaller than its windows")
    lib = _build.library()
    n = cy.shape[0]
    dev = prev_f.device
    corners = [t.to(torch.int32).contiguous() for t in (cy, cx, sy, sx)]
    raw = torch.empty((n, 3, win_h + 1, win_w + 1), dtype=torch.float32,
                      device=dev)
    sw = torch.empty((n, sw_h, sw_w), dtype=torch.float32, device=dev)
    _build.launch(lib.lk_window_gather_launch, prev_f, "window gather",
                  prev_f.data_ptr(), next_f.data_ptr(),
                  *(t.data_ptr() for t in corners), raw.data_ptr(),
                  sw.data_ptr(), n, fh, fw, win_h, win_w, sw_h, sw_w)
    kernel_launches += 1
    return raw, sw


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/window_gather.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lk_window_gather_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.lk_window_gather_launch.restype = i


# ---------------------------------------------------------------------------
# pyramid fold
# ---------------------------------------------------------------------------

def _level_row_bands(h0: int, cfg: LKConfig, row_band):
    """Per-level (r0, r1) crops of a full-res tracker row band (or None)."""
    if row_band is None:
        return [None] * (cfg.max_level + 1)
    r0, r1 = row_band
    bands, h = [], h0
    for lv in range(cfg.max_level + 1):
        rr0 = max(0, (r0 >> lv) - _BAND_MARGIN)
        rr1 = min(h, -(-r1 // (1 << lv)) + _BAND_MARGIN)
        bands.append(None if (rr0 == 0 and rr1 >= h) else (rr0, rr1))
        h = -(-h // 2)
    return bands


def _fold(x3: torch.Tensor, band, pad: int) -> torch.Tensor:
    """(B, h, w) level -> (B * (rows + 2*(pad+1)), w + 2*pad): per frame a
    REFLECT_101 pad plus one guard row at each seam, folded along rows."""
    b, h, w = x3.shape
    cols = reflect101_index(w, pad, pad, x3.device)
    if band is not None and band[0] >= pad + 1 and band[1] + pad + 1 <= h:
        # interior band: the row pad comes from the true frame
        x3 = x3[:, band[0] - pad - 1:band[1] + pad + 1]
    else:
        if band is not None:
            x3 = x3[:, band[0]:band[1]]
        rows = reflect101_index(x3.shape[1], pad + 1, pad + 1, x3.device)
        x3 = x3.index_select(1, rows)
    xp = x3.index_select(2, cols)
    return xp.reshape(b * xp.shape[1], xp.shape[2])


def fold_tracking_levels(imgs: torch.Tensor, cfg: LKConfig = LKConfig(),
                         row_band=None):
    """Pyramid + fold of a (B, H, W) frame batch for the batched tracker
    (``lk_tpu.flow.sparse.fold_tracking_levels``): per level, the B frames
    reflect-padded (window pad + one guard row per frame seam) and folded
    along rows into one tall 2-D array; with ``row_band`` each level keeps
    only that band plus ``_BAND_MARGIN`` rows per side.  The pyramid is
    decimated before the crop."""
    pad = max(cfg.win_size) + 2
    levels = build_pyramid(imgs, cfg.max_level)
    bands = _level_row_bands(imgs.shape[1], cfg, row_band)
    return tuple(_fold(lv, bd, pad) for lv, bd in zip(levels, bands))


# ---------------------------------------------------------------------------
# the per-point tracker (single stream)
# ---------------------------------------------------------------------------

@_device_cache
def reflect_index(n: int, before: int, after: int,
                  device: torch.device) -> torch.Tensor:
    """Source indices of an axis of length n padded by ``before``/``after``
    with REFLECT_101, reflected again wherever the pad reaches past the far
    edge: ``np.pad`` / ``jnp.pad(mode="reflect")`` for any pad width."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def build_tracking_pyramid(img: torch.Tensor, max_level: int, pad: int):
    """Pyramid of (..., H, W) planes (one ``build_pyramid`` call for all of
    them) whose levels are REFLECT_101-padded by ``pad`` pixels, so windows
    of points near the border read reflected content
    (cv.buildOpticalFlowPyramid's border)."""
    out = []
    for lv in build_pyramid(img, max_level):
        h, w = lv.shape[-2:]
        out.append(lv.index_select(-2, reflect_index(h, pad, pad, lv.device))
                   .index_select(-1, reflect_index(w, pad, pad, lv.device)))
    return out


@_device_cache
def _window_geometry(win_w: int, win_h: int, pad: int, hp: int, wp: int,
                     device: torch.device):
    """Constants of the window sampling on one (hp, wp) padded level, as
    (x, y) pairs: the window's half size, the bounds of OpenCV's 'inside'
    test (the integer corner within [-win, size) of the unpadded level),
    the corner's upper clamp; and the (win_h+1, win_w+1) patch's offsets
    into the flattened level.  Filled on the device, with no host copy, so
    that a CUDA graph capture can build its own."""

    def pair(x, y, dtype):
        out = torch.empty(2, dtype=dtype, device=device)
        out[0].fill_(x)
        out[1].fill_(y)
        return out

    f32, i64 = torch.float32, torch.int64
    half = pair((win_w - 1) * 0.5, (win_h - 1) * 0.5, f32)
    lo = pair(-win_w, -win_h, f32)
    hi = pair(wp - 2 * pad, hp - 2 * pad, f32)
    cmax = pair(wp - win_w - 1, hp - win_h - 1, i64)
    offs = (torch.arange(win_h + 1, device=device)[:, None] * wp
            + torch.arange(win_w + 1, device=device))
    return half, lo, hi, cmax, offs


def _sample_patch(planes, q, geom, pad: int, wp: int):
    """Bilinear (win_h, win_w) windows centred at q (n, 2) of flattened
    padded planes ((C,) Hp*Wp): the (win_h+1, win_w+1) patch at the
    integer corner, clamped into the level, then the four taps weighted
    and summed in lk_tpu's ``_sample_patch`` order.  Returns the ((C,) n,
    win_h, win_w) windows and OpenCV's 'inside' test of each point."""
    half, lo, hi, cmax, offs = geom
    qq = q - half
    iq = torch.floor(qq)
    f = qq - iq
    inside = ((iq >= lo) & (iq < hi)).all(dim=-1)
    c = torch.minimum((iq.to(torch.int64) + pad).clamp(min=0), cmax)
    raw = planes[..., (c[:, 1] * wp + c[:, 0])[:, None, None] + offs]
    # w[y][x] = wx * wy with wx, wy in (1 - f, f): w00 = (1-fx)(1-fy),
    # w01 = fx(1-fy), w10 = (1-fx)fy, w11 = fx fy
    s = torch.stack([1.0 - f, f], dim=-1)
    w = (s[:, 0, None, :] * s[:, 1, :, None]).reshape(-1, 4, 1, 1)
    out = (raw[..., :-1, :-1] * w[:, 0] + raw[..., :-1, 1:] * w[:, 1]
           + raw[..., 1:, :-1] * w[:, 2] + raw[..., 1:, 1:] * w[:, 3])
    return out, inside


def _track_one_level(prev_pad, ix_pad, iy_pad, next_pad, prev_pt, next_pt,
                     status, cfg: LKConfig, pad: int, is_level0: bool):
    """One pyramid level of refinement of every point (``lk_tpu``'s, vmapped
    over points): the prev/ix/iy windows and their structure tensor, the
    min-eig gate, then ``cfg.max_iters`` masked Newton steps.  Returns
    (next_pt, status, p_win, the level's sampling geometry)."""
    win_w, win_h = cfg.win_size
    hp, wp = prev_pad.shape
    geom = _window_geometry(win_w, win_h, pad, hp, wp, prev_pad.device)
    wins, prev_inside = _sample_patch(
        torch.stack([prev_pad, ix_pad, iy_pad]).reshape(3, -1), prev_pt,
        geom, pad, wp)
    p_win, ix_win, iy_win = wins
    ixy_win = wins[1:]
    a11 = (ix_win * ix_win).sum(dim=(1, 2))
    a12 = (ix_win * iy_win).sum(dim=(1, 2))
    a22 = (iy_win * iy_win).sum(dim=(1, 2))
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) \
        / (2.0 * win_w * win_h)
    # OpenCV's 1e-4 threshold on its fixed-point scale is min_eig/1024 on
    # the normalized-gradient scale (lk_tpu/flow/sparse.py)
    good_g = (min_eig >= cfg.min_eig_threshold * 1024.0) & (det > 1e-7)
    inv_det = torch.where(det > 1e-7, 1.0 / det, 0.0)
    a_diag = torch.stack([a22, a11])
    if is_level0:
        status = status & prev_inside & good_g
    do_refine = prev_inside & good_g

    eps2 = cfg.eps * cfg.eps
    next_flat = next_pad.reshape(-1)
    nxt = next_pt
    prev_delta = torch.zeros_like(nxt)
    active = do_refine
    inside_ok = torch.ones_like(active)
    for j in range(cfg.max_iters):
        j_win, next_inside = _sample_patch(next_flat, nxt, geom, pad, wp)
        b = ((j_win - p_win) * ixy_win).sum(dim=(2, 3))     # (b1, b2)
        # (a12 b2 - a22 b1, a12 b1 - a11 b2) / det
        delta = ((a12 * b.flip(0) - a_diag * b) * inv_det).T
        step_ok = active & next_inside
        new_nxt = torch.where(step_ok[:, None], nxt + delta, nxt)
        still = step_ok & ~((delta * delta).sum(dim=-1) <= eps2)
        if j > 0:           # OpenCV's damping: successive steps cancel
            osc = ((delta + prev_delta).abs() < 0.01).all(dim=-1)
            new_nxt = torch.where((step_ok & osc)[:, None],
                                  new_nxt - delta * 0.5, new_nxt)
            still = still & ~osc
        inside_ok = torch.where(active, next_inside, inside_ok)
        nxt, prev_delta, active = new_nxt, delta, still
    if is_level0:
        status = status & (inside_ok | ~do_refine)
    return nxt, status, p_win, geom


def track_points(prev_img: torch.Tensor, next_img: torch.Tensor,
                 pts: torch.Tensor, valid: torch.Tensor,
                 cfg: LKConfig = LKConfig()):
    """Track ``pts`` (N, 2) float (x, y) from prev_img to next_img (H, W).

    Returns (new_pts (N, 2) f32, status (N,) bool, err (N,) f32): err is
    the mean |window difference| at the final position at level 0.
    ``valid`` masks inactive slots (passthrough, status False).  The
    equivalent of cv.calcOpticalFlowPyrLK (reference LK_Final.py:531-532).
    """
    pad = max(cfg.win_size) + 2
    with span("tracker.pyramid"):
        levels = build_tracking_pyramid(torch.stack([prev_img, next_img]),
                                        cfg.max_level, pad)
    pts = pts.to(torch.float32)
    status = valid
    next_pt = pts / float(2 ** cfg.max_level)
    for level in range(cfg.max_level, -1, -1):
        prev_pad, next_pad = levels[level]
        with span("tracker.scharr"):
            ix_pad, iy_pad = scharr_derivatives(prev_pad)
        prev_pt = pts / float(2 ** level)
        if level != cfg.max_level:
            next_pt = next_pt * 2.0
        with span("tracker.refine"):
            next_pt, status, p_win, geom = _track_one_level(
                prev_pad, ix_pad, iy_pad, next_pad, prev_pt, next_pt, status,
                cfg, pad, is_level0=level == 0)
    with span("tracker.refine"):
        # err: mean |window difference| at the final position (OpenCV's)
        j_win, _ = _sample_patch(next_pad.reshape(-1), next_pt, geom, pad,
                                 next_pad.shape[1])
        err = (j_win - p_win).abs().mean(dim=(1, 2))
        new_pts = torch.where(valid[:, None], next_pt, pts)
    return new_pts, status & valid, err


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

def track_points_batched(prev_imgs, next_imgs, pts, valid,
                         cfg: LKConfig = LKConfig(), row_band=None):
    """Track (B, N, 2) points across B same-size frame pairs; returns
    (new_pts (B, N, 2), status (B, N), err (B, N))."""
    prev_folded = fold_tracking_levels(prev_imgs, cfg, row_band=row_band)
    p1, st, err, _ = track_points_batched_prepped(
        prev_folded, next_imgs, pts, valid, cfg, row_band=row_band)
    return p1, st, err


def _bilinear_weights(q, half_x, half_y):
    """Integer corner and fractional offsets of windows centred at q."""
    qx = q[:, 0] - half_x
    qy = q[:, 1] - half_y
    iqx = torch.floor(qx)
    iqy = torch.floor(qy)
    return iqx, iqy, qx - iqx, qy - iqy


def _refine_level(raw, sw, fx, fy, next_pt, prev_inside, sy, sx, geom,
                  cfg: LKConfig, area2, with_err: bool):
    """One pyramid level of the batched tracker after its gather: the
    bilinear prev/ix/iy windows and their structure tensor, the min-eig
    gate, then ``cfg.max_iters`` masked Newton steps of every point inside
    its superwindow ``sw`` (lk_tpu's while loop over ``any(active)``).

    geom = (r0, pad, w, h_true): band origin, window pad, level width and
    true height.  Returns (next_pt, good (inside and gated), kept (inside
    at the end, or never refined), err (level 0 only, else None))."""
    r0, pad, w, h_true = geom
    nn = raw.shape[0]
    dev = raw.device
    win_w, win_h = cfg.win_size
    half_x = (win_w - 1) * 0.5
    half_y = (win_h - 1) * 0.5
    sw_h, sw_w = sw.shape[1:]
    w00 = ((1.0 - fx) * (1.0 - fy))[:, None, None]
    w01 = (fx * (1.0 - fy))[:, None, None]
    w10 = ((1.0 - fx) * fy)[:, None, None]
    w11 = (fx * fy)[:, None, None]

    def lerp4(r):
        return (r[:, :-1, :-1] * w00 + r[:, :-1, 1:] * w01
                + r[:, 1:, :-1] * w10 + r[:, 1:, 1:] * w11)

    p_win = lerp4(raw[:, 0])
    ix_win = lerp4(raw[:, 1])
    iy_win = lerp4(raw[:, 2])
    a11 = (ix_win * ix_win).sum(dim=(1, 2))
    a12 = (ix_win * iy_win).sum(dim=(1, 2))
    a22 = (iy_win * iy_win).sum(dim=(1, 2))
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2
                                      + 4.0 * a12 * a12)) / area2
    good = prev_inside & (min_eig >= cfg.min_eig_threshold * 1024.0) \
        & (det > 1e-7)
    inv_det = torch.where(det > 1e-7, 1.0 / det, 0.0)

    max_dy = sw_h - win_h - 1
    max_dx = sw_w - win_w - 1
    rows_w = torch.arange(win_h, device=dev)
    cols_w = torch.arange(win_w, device=dev)

    def sample_next(q):
        """Bilinear (win_h, win_w) windows at q inside sw: the two taps per
        axis, rows then columns."""
        iqx, iqy, gx, gy = _bilinear_weights(q, half_x, half_y)
        dyi = (iqy.to(torch.int64) - r0 + pad - sy).clamp(0, max_dy)
        dxi = (iqx.to(torch.int64) + pad - sx).clamp(0, max_dx)
        ri = (dyi[:, None] + rows_w)[:, :, None].expand(nn, win_h, sw_w)
        gy3 = gy[:, None, None]
        vert = (1.0 - gy3) * sw.gather(1, ri) + gy3 * sw.gather(1, ri + 1)
        ci = (dxi[:, None] + cols_w)[:, None, :].expand(nn, win_h, win_w)
        gx3 = gx[:, None, None]
        return ((1.0 - gx3) * vert.gather(2, ci)
                + gx3 * vert.gather(2, ci + 1))

    def inside_next(q):
        iqx = torch.floor(q[:, 0] - half_x)
        iqy = torch.floor(q[:, 1] - half_y)
        return ((iqx >= -win_w) & (iqx < w)
                & (iqy >= -win_h) & (iqy < h_true))

    eps2 = cfg.eps * cfg.eps
    nxt = next_pt
    prev_delta = torch.zeros((nn, 2), dtype=torch.float32, device=dev)
    active = good
    inside_ok = torch.ones((nn,), dtype=torch.bool, device=dev)
    for j in range(cfg.max_iters):
        j_win = sample_next(nxt)
        nx_inside = inside_next(nxt)
        diff = j_win - p_win
        b1 = (diff * ix_win).sum(dim=(1, 2))
        b2 = (diff * iy_win).sum(dim=(1, 2))
        delta = torch.stack([(a12 * b2 - a22 * b1) * inv_det,
                             (a12 * b1 - a11 * b2) * inv_det], dim=-1)
        step_ok = active & nx_inside
        new_nxt = torch.where(step_ok[:, None], nxt + delta, nxt)
        converged = (delta * delta).sum(dim=-1) <= eps2
        still = active & nx_inside & ~converged
        if j > 0:           # OpenCV's damping: successive steps cancel
            osc = (((delta[:, 0] + prev_delta[:, 0]).abs() < 0.01)
                   & ((delta[:, 1] + prev_delta[:, 1]).abs() < 0.01))
            new_nxt = torch.where((step_ok & osc)[:, None],
                                  new_nxt - delta * 0.5, new_nxt)
            still = still & ~osc
        inside_ok = torch.where(active, nx_inside, inside_ok)
        nxt, prev_delta, active = new_nxt, delta, still
    err = (sample_next(nxt) - p_win).abs().mean(dim=(1, 2)) \
        if with_err else None
    return nxt, good, inside_ok | ~good, err


def track_points_batched_prepped(prev_folded, next_imgs, pts, valid,
                                 cfg: LKConfig = LKConfig(), row_band=None):
    """``track_points_batched`` with the prev batch's fold carried in;
    also returns next's folded levels for the following step.

    ``row_band`` must be the one ``prev_folded`` was built with; valid
    points lie inside it (results for points outside sample clamped band
    content, as in ``lk_tpu``)."""
    b, h0, _ = next_imgs.shape
    n = pts.shape[1]
    nn = b * n
    dev = next_imgs.device
    win_w, win_h = cfg.win_size
    pad = max(win_w, win_h) + 2
    half_x = (win_w - 1) * 0.5
    half_y = (win_h - 1) * 0.5
    bands = _level_row_bands(h0, cfg, row_band)
    h_levels, _h = [], h0
    for _ in range(cfg.max_level + 1):
        h_levels.append(_h)
        _h = -(-_h // 2)

    with span("tracker.fold"):
        next_folded = fold_tracking_levels(next_imgs, cfg, row_band=row_band)
    if len(prev_folded) != cfg.max_level + 1 \
            or prev_folded[0].shape != next_folded[0].shape:
        raise ValueError("prev_folded was built for another batch geometry")

    frame_idx = torch.arange(b, device=dev).repeat_interleave(n)
    flat_pts = pts.reshape(nn, 2).to(torch.float32)
    flat_valid = valid.reshape(nn)
    status = flat_valid
    next_pt = flat_pts / float(2 ** cfg.max_level)
    err = None
    area2 = torch.full((), 2.0 * win_w * win_h, dtype=torch.float32,
                       device=dev)

    for level in range(cfg.max_level, -1, -1):
        prev_f = prev_folded[level]
        next_f = next_folded[level]
        h = prev_f.shape[0] // b - 2 * (pad + 1)
        w = prev_f.shape[1] - 2 * pad
        band = bands[level]
        r0 = 0 if band is None else band[0]
        h_true = h_levels[level]
        if h != (h_true if band is None else band[1] - band[0]):
            raise ValueError("prev_folded was built with a different "
                             f"row_band (level {level}, {h} rows)")
        fph = h + 2 * pad
        fpw = w + 2 * pad
        base_y = frame_idx * (fph + 2) + 1
        sw_h = min(_SW_ROWS, fph)
        sw_w = min(_SW_COLS, fpw)

        prev_pt = flat_pts / float(2 ** level)
        if level != cfg.max_level:
            next_pt = next_pt * 2.0

        # --- prev/ix/iy window and the next superwindow ------------------
        ipx, ipy, fx, fy = _bilinear_weights(prev_pt, half_x, half_y)
        prev_inside = ((ipx >= -win_w) & (ipx < w) & (ipy >= -win_h)
                       & (ipy < h_true))
        cx = (ipx.to(torch.int64) + pad).clamp(0, fpw - win_w - 1)
        cy = (ipy.to(torch.int64) - r0 + pad).clamp(0, fph - win_h - 1) \
            + base_y
        sy = (torch.floor(next_pt[:, 1] - half_y).to(torch.int64) - r0 + pad
              - (sw_h - win_h - 1) // 2).clamp(0, fph - sw_h)
        sx = (torch.floor(next_pt[:, 0] - half_x).to(torch.int64) + pad
              - (sw_w - win_w - 1) // 2).clamp(0, fpw - sw_w)
        with span("tracker.gather"):
            raw, sw = gather_windows(prev_f, next_f, cy, cx, sy + base_y, sx,
                                     win_h, win_w, sw_h, sw_w)
        with span("tracker.refine"):
            next_pt, good, kept, lvl_err = _refine_level(
                raw, sw, fx, fy, next_pt, prev_inside, sy, sx,
                (r0, pad, w, h_true), cfg, area2, with_err=level == 0)
        if level == 0:
            status = status & good & kept
            err = lvl_err

    new_pts = torch.where(flat_valid[:, None], next_pt, flat_pts)
    return (new_pts.reshape(b, n, 2), (status & flat_valid).reshape(b, n),
            err.reshape(b, n), next_folded)
