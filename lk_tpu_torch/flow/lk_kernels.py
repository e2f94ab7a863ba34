"""The fused inverse-compositional LK level: kernel wrapper and plain version.

Counterpart of the four grads-in-kernel Pallas makers of
``lk_tpu/flow/pallas_kernels.py``:

* ``make_fused_lk_level_grads_resident_batched`` (top level, K pairs),
* ``make_fused_lk_level_grads_batched`` (coarse-in finer level, K pairs),
* ``make_fused_lk_level_grads_resident`` (top level, one pair),
* ``make_fused_lk_level_grads`` (tiled level, one pair; coarse-in, or
  full-resolution flow with ``n_iters`` Jacobi iterations).

All four compute one thing, so here they are one function with switches:
K pairs (K=1 is the single-pair form), ``coarse_in``, ``write_stats`` and
``n_iters``.  A tile that covers the whole level is the resident form.

``fused_lk_level`` dispatches on the device of its inputs: CPU tensors go to
``fused_lk_level_reference`` (plain PyTorch), CUDA tensors to the CUDA kernel
``lk_tpu_torch/csrc/fused_lk_level.cu``.  There is no fallback between the
two: a kernel that fails to build or launch raises.

Semantics (per pair f: prev[f] -> next[f], per reference tile (th, tw)):

* The warp window is centred on the tile's reference displacement
  ``d0 = round_half_even(clip(ref, +-max_disp))``; ref is the flow at the
  tile centre, or twice the dominant coarse tap there on coarse-in levels.
  The tile's 8-pixel halo is warped with the same reference.
* Warp: separable two-tap tent, vertical pass first; a residual beyond
  ``+-local`` of the reference clamps.
* Exact f32 Scharr of edge-replicated prev; 15x15 box sums as shifted adds
  (rows, then columns, in tap order); gate at ``min_eig_threshold * 1024``.
* Flow on the halo: inside the level, the previous iteration's flow;
  outside, the edge-replicated initial flow, every iteration.  On coarse-in
  levels, ``upsample2_linear``'s taps (x2) of the edge-clamped coarse planes.

The TPU kernels round the box-sum and coarse-upsample data to bf16 (the MXU
band matmuls) and may take a bf16 Scharr (``scharr_mxu``).  Those are TPU
precision trades: this port always computes the exact f32 form.  One
layout effect of the TPU's is reproduced: the tiled (ping-pong) kernel
writes 128-aligned output widths, so from the second iteration on, at
``tile_w % 128 != 0``, the first ``warp_kernels.right_spill(tile_w)``
columns right of the level (in the level's rows) carry the current flow's
edge column instead of the initial flow.  The resident kernels keep the
initial flow there.  The 1080p video path never meets this (its tiled
levels iterate once, its top is resident at 256 columns); a tiled level
with iterations does (tests/test_torch_lk_level.py pins it against the
TPU kernel), as the precomputed-A level does (``warp_kernels``).
"""

from __future__ import annotations

import ctypes

import torch

HALO = 8          # halo rows/cols around a tile (15x15 window -> +-7, +1)
MAX_LOCAL = 8     # largest warp residual range the CUDA kernel is built for
# The CUDA kernel's output block shapes (rows, cols), by the index its
# launch takes.
BLOCK_SHAPES = ((34, 32), (17, 32))

# Counters: kernel launches (one per iteration per call) by TPU-kernel
# variant, and calls of the plain version.
kernel_launches_by_variant = {
    "resident_batched": 0, "batched": 0, "resident": 0, "tiled": 0}
plain_calls = 0


def reset_counters() -> None:
    global plain_calls
    plain_calls = 0
    for k in kernel_launches_by_variant:
        kernel_launches_by_variant[k] = 0


def pick_tile_w(w: int) -> tuple[int, int]:
    """(tile_w, padded_w) minimizing frame padding, as ``lk_tpu`` picks it.

    Kept identical because the tile width is part of the numerics: each
    tile warps with its own reference displacement."""
    if w <= 512:
        return w, w
    best = None
    for tw in (512, 384, 256, 128):
        padded = -(-w // tw) * tw
        waste = padded - w
        if best is None or waste < best[0]:
            best = (waste, tw, padded)
    _, tw, padded = best
    return tw, padded


def variant(k: int, h: int, w: int, tile_h: int, tile_w: int,
            coarse_in: bool, resident: bool | None = None) -> str:
    """Which TPU kernel a call stands in for (counter and report key).
    ``resident`` None: a tile that covers the whole level is the resident
    form."""
    if resident is None:
        resident = (h, w) == (tile_h, tile_w)
    resident = resident and not coarse_in
    if k > 1:
        return "resident_batched" if resident else "batched"
    return "resident" if resident else "tiled"


def _check_args(prev, nxt, flow, tile_h, tile_w, local, n_iters, coarse_in,
                win_k):
    if prev.ndim != 3 or nxt.shape != prev.shape:
        raise ValueError(f"prev/next must be (K, H, W): {prev.shape} "
                         f"{nxt.shape}")
    k, h, w = prev.shape
    if h % tile_h or w % tile_w:
        raise ValueError(f"level {h}x{w} is not a multiple of the tile "
                         f"{tile_h}x{tile_w}")
    if coarse_in:
        if n_iters != 1:
            raise ValueError("coarse_in takes exactly one iteration")
        if h % 2 or w % 2 or tile_h % 2 or tile_w % 2:
            raise ValueError("coarse_in needs even level and tile sizes")
        want = (k, 2, h // 2, w // 2)
    else:
        want = (k, 2, h, w)
    if tuple(flow.shape) != want:
        raise ValueError(f"flow shape {tuple(flow.shape)}, expected {want}")
    if not 1 <= win_k <= 2 * HALO - 1:
        raise ValueError(f"win_k {win_k} outside 1..{2 * HALO - 1}")
    if not 0 <= local <= MAX_LOCAL:
        raise ValueError(f"local {local} outside 0..{MAX_LOCAL}")
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    for name, t in (("prev", prev), ("next", nxt), ("flow", flow)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != prev.device:
            raise ValueError(f"{name} on {t.device}, prev on {prev.device}")


def fused_lk_level(prev: torch.Tensor, nxt: torch.Tensor, flow: torch.Tensor,
                   *, tile_h: int, tile_w: int, max_disp: int, local: int,
                   n_iters: int = 1, coarse_in: bool = False,
                   write_stats: bool = True, min_eig_threshold: float = 1e-4,
                   win_k: int = 15, resident: bool | None = None):
    """One pyramid level of fused IC dense LK for K pairs.

    prev, nxt: (K, H, W) float32, pair f is prev[f] -> nxt[f] (views such
    as ``frames[:-1]`` / ``frames[1:]`` are fine).  flow: (K, 2, H, W)
    initial flow planes, or (K, 2, H/2, W/2) coarser-level planes with
    ``coarse_in``.  ``resident``: whether the call stands in for a resident
    TPU kernel (no right-halo refresh, module docstring); None: when one
    tile covers the level.  Returns (flow (K, 2, H, W), min_eig (K, H, W),
    valid (K, H, W) bool); the stats are None without ``write_stats``.
    """
    kw = dict(tile_h=tile_h, tile_w=tile_w, max_disp=max_disp, local=local,
              n_iters=n_iters, coarse_in=coarse_in, write_stats=write_stats,
              min_eig_threshold=min_eig_threshold, win_k=win_k,
              resident=resident)
    if prev.device.type == "cpu":
        return fused_lk_level_reference(prev, nxt, flow, **kw)
    if prev.device.type != "cuda":
        raise ValueError(f"fused_lk_level: unsupported device {prev.device}")
    return _fused_lk_level_cuda(prev, nxt, flow, **kw)


def _spill(it: int, k: int, h: int, w: int, tile_h: int, tile_w: int,
           coarse_in: bool, resident: bool | None) -> int:
    """Columns right of the level that iteration ``it`` reads as the
    current flow's edge (module docstring): the tiled TPU kernel's
    128-aligned writes, from the second iteration on."""
    from lk_tpu_torch.flow import warp_kernels

    if it == 0 or variant(k, h, w, tile_h, tile_w, coarse_in,
                          resident).startswith("resident"):
        return 0
    return warp_kernels.right_spill(tile_w)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _frame_stride(t: torch.Tensor) -> int:
    """Pair stride in elements of a (K, H, W) plane stack whose planes are
    each row-major contiguous."""
    _, h, w = t.shape
    if t.stride(2) != 1 or t.stride(1) != w:
        raise ValueError(f"planes must be row-major contiguous: stride "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    return t.stride(0)


def _fused_lk_level_cuda(prev, nxt, flow, *, tile_h, tile_w, max_disp, local,
                         n_iters, coarse_in, write_stats, min_eig_threshold,
                         win_k, resident=None, shape=-1):
    """The kernel's launches.  ``shape`` picks the block shape (an index
    into ``BLOCK_SHAPES``; -1: the kernel's own choice from the level's
    size); every shape computes the same bits."""
    from lk_tpu_torch import _build

    _check_args(prev, nxt, flow, tile_h, tile_w, local, n_iters, coarse_in,
                win_k)
    lib = _build.library()
    k, h, w = prev.shape
    ps, ns = _frame_stride(prev), _frame_stride(nxt)
    init = flow.contiguous()
    dev = prev.device
    me = torch.empty((k, h, w), dtype=torch.float32, device=dev) \
        if write_stats else None
    va = torch.empty((k, h, w), dtype=torch.bool, device=dev) \
        if write_stats else None
    thr = float(min_eig_threshold) * 1024.0
    ch, cw = (h // 2, w // 2) if coarse_in else (0, 0)
    key = variant(k, h, w, tile_h, tile_w, coarse_in, resident)
    cur = None if coarse_in else init
    bufs = []
    for it in range(n_iters):
        if len(bufs) < 2:
            bufs.append(torch.empty((k, 2, h, w), dtype=torch.float32,
                                    device=dev))
        out = bufs[it % 2]
        stats = it == 0 and write_stats
        _build.launch(
            lib.lk_fused_level_launch, prev, "fused_lk_level",
            prev.data_ptr(), ps, nxt.data_ptr(), ns,
            cur.data_ptr() if cur is not None else None, init.data_ptr(),
            out.data_ptr(),
            me.data_ptr() if stats else None,
            va.data_ptr() if stats else None,
            k, h, w, ch, cw, tile_h, tile_w, int(coarse_in), local, win_k,
            _spill(it, k, h, w, tile_h, tile_w, coarse_in, resident),
            float(max_disp), thr, shape)
        kernel_launches_by_variant[key] += 1
        cur = out
    return cur, me, va


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/fused_lk_level.cu``."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.lk_fused_level_launch.argtypes = [
        p, ll, p, ll,          # prev, prev pair stride, next, next stride
        p, p, p, p, p,         # cur, init, out, min_eig, valid
        i, i, i, i, i,         # K, H, W, CH, CW
        i, i, i, i, i, i,      # tile_h, tile_w, coarse, local, win_k,
                               # spill
        f, f, i, p,            # max_disp, eig_thr, block shape, stream
    ]
    lib.lk_fused_level_launch.restype = i
    lib.lk_error_string.argtypes = [i]
    lib.lk_error_string.restype = ctypes.c_char_p


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def fused_lk_level_reference(prev: torch.Tensor, nxt: torch.Tensor,
                             flow: torch.Tensor, *, tile_h: int, tile_w: int,
                             max_disp: int, local: int, n_iters: int = 1,
                             coarse_in: bool = False,
                             write_stats: bool = True,
                             min_eig_threshold: float = 1e-4,
                             win_k: int = 15,
                             resident: bool | None = None):
    """Plain PyTorch form of ``fused_lk_level``: same signature, same
    semantics, one Python iteration per reference tile.

    Every value is formed by the same f32 operations in the same order as
    the CUDA kernel (which is built without FMA contraction), and the box
    sums are shifted adds, never a reduction whose order could depend on
    the batch shape — so per pair the result does not depend on K."""
    global plain_calls
    _check_args(prev, nxt, flow, tile_h, tile_w, local, n_iters, coarse_in,
                win_k)
    plain_calls += 1
    k, h, w = prev.shape
    dev = prev.device
    init = flow
    cur = None if coarse_in else flow
    me = torch.empty((k, h, w), dtype=torch.float32, device=dev) \
        if write_stats else None
    va = torch.empty((k, h, w), dtype=torch.bool, device=dev) \
        if write_stats else None
    thr = float(min_eig_threshold) * 1024.0
    for it in range(n_iters):
        spill = _spill(it, k, h, w, tile_h, tile_w, coarse_in, resident)
        out = torch.empty((k, 2, h, w), dtype=torch.float32, device=dev)
        for ty0 in range(0, h, tile_h):
            for tx0 in range(0, w, tile_w):
                f, m, v = _tile_step(
                    prev, nxt, cur, init, coarse_in, ty0, tx0, tile_h,
                    tile_w, float(max_disp), local, win_k, thr, spill)
                out[:, :, ty0:ty0 + tile_h, tx0:tx0 + tile_w] = f
                if it == 0 and write_stats:
                    me[:, ty0:ty0 + tile_h, tx0:tx0 + tile_w] = m
                    va[:, ty0:ty0 + tile_h, tx0:tx0 + tile_w] = v
        cur = out
    return cur, me, va


def _coarse_taps(pos: torch.Tensor, n: int):
    """upsample2_linear's two taps of full-resolution positions ``pos``
    (any integers, also outside the level) into an n-long coarse axis,
    edge-clamped, with their (0.25, 0.75) / (0.75, 0.25) weights."""
    lo = torch.div(pos - 1, 2, rounding_mode="floor")
    even = torch.remainder(pos, 2) == 0
    w_lo = torch.where(even, 0.25, 0.75).to(torch.float32)
    w_hi = torch.where(even, 0.75, 0.25).to(torch.float32)
    return lo.clamp(0, n - 1), (lo + 1).clamp(0, n - 1), w_lo, w_hi


def _flow_planes(cur, init, coarse_in, ys, xs, h, w, spill=0):
    """(K, 2, len(ys), len(xs)) flow at frame positions ys x xs (rule of
    the module docstring: current flow inside the level, initial flow
    edge-replicated outside; or the x2 coarse upsample).  ``spill`` > 0
    also gives the first ``spill`` columns right of the level, in the
    level's rows, the current flow's edge column (the tiled levels' right
    halo from their second iteration on)."""
    if coarse_in:
        ch, cw = init.shape[-2:]
        ylo, yhi, wly, why = _coarse_taps(ys, ch)
        xlo, xhi, wlx, whx = _coarse_taps(xs, cw)
        # columns first, then rows (the TPU kernel's band-matmul order)
        t_lo = wlx * init[:, :, ylo][..., xlo] + whx * init[:, :, ylo][..., xhi]
        t_hi = wlx * init[:, :, yhi][..., xlo] + whx * init[:, :, yhi][..., xhi]
        return ((2.0 * wly)[:, None] * t_lo
                + (2.0 * why)[:, None] * t_hi)
    yc, xc = ys.clamp(0, h - 1), xs.clamp(0, w - 1)
    inside = (((ys >= 0) & (ys < h))[:, None]
              & ((xs >= 0) & (xs < w + spill))[None, :])
    return torch.where(inside, cur[:, :, yc][..., xc],
                       init[:, :, yc][..., xc])


def _box(q: torch.Tensor, th: int, tw: int, win_k: int) -> torch.Tensor:
    """win_k x win_k sums at the tile pixels of an extended-region array:
    tile pixel (r, c) sums ext rows r+1..r+win_k and cols c+1..c+win_k."""
    v = q[:, 1:1 + th]
    for d in range(2, win_k + 1):
        v = v + q[:, d:d + th]
    o = v[:, :, 1:1 + tw]
    for d in range(2, win_k + 1):
        o = o + v[:, :, d:d + tw]
    return o


def warp_region(nxt, fx, fyw, y0, x0, ref, bound, local):
    """The tile-reference separable warp of a region, all K pairs (the plain
    form of csrc/warp_tile.cuh and of the Pallas _warp_core).

    nxt: (K, H, W) level.  The region is fx.shape[-2:] = (rh, rw) pixels
    from level position (y0, x0); fx: (K, rh, rw) flow x on it; fyw: (K, rh,
    rw + 2*local + 1) flow y on it, column j taken at region column
    min(j, rw - 1) (the vertical pass runs on the window's extra columns
    with the edge column's dy); ref: (K, 2) reference flow.  Returns the
    warped region (K, rh, rw)."""
    k, h, w = nxt.shape
    rh, rw = fx.shape[-2:]
    dev = nxt.device
    wide = rw + 2 * local + 1                 # columns the vertical pass makes
    kk = torch.arange(k, device=dev)
    d0 = torch.round(ref.clamp(-bound, bound)).to(torch.int64)
    wy0 = y0 + d0[:, 1] - local               # window origin, per pair
    wx0 = x0 + d0[:, 0] - local

    # window of next, edge-clamped
    wr = (wy0[:, None] + torch.arange(rh + 2 * local + 1, device=dev)
          ).clamp(0, h - 1)
    wc = (wx0[:, None] + torch.arange(wide, device=dev)).clamp(0, w - 1)
    win = nxt[kk[:, None, None], wr[:, :, None], wc[:, None, :]]

    two_l = 2.0 * local
    rows_f = torch.arange(rh, device=dev, dtype=torch.float32)[:, None]
    gy = ((rows_f + y0) + fyw.clamp(-bound, bound)).clamp(0.0, h - 1.0)
    rel = ((gy - wy0.to(torch.float32)[:, None, None]) - rows_f
           ).clamp(0.0, two_l)
    di = torch.floor(rel)
    fr = rel - di
    idx = di.to(torch.int64) + torch.arange(rh, device=dev)[:, None]
    vert = (1.0 - fr) * win.gather(1, idx) + fr * win.gather(1, idx + 1)

    cols_f = torch.arange(rw, device=dev, dtype=torch.float32)[None, :]
    gx = ((cols_f + x0) + fx.clamp(-bound, bound)).clamp(0.0, w - 1.0)
    rel = ((gx - wx0.to(torch.float32)[:, None, None]) - cols_f
           ).clamp(0.0, two_l)
    dj = torch.floor(rel)
    fr = rel - dj
    jdx = dj.to(torch.int64) + torch.arange(rw, device=dev)[None, :]
    return (1.0 - fr) * vert.gather(2, jdx) + fr * vert.gather(2, jdx + 1)


def _tile_step(prev, nxt, cur, init, coarse_in, ty0, tx0, th, tw, bound,
               local, win_k, thr, spill):
    """One IC iteration of the reference tile at (ty0, tx0), all K pairs."""
    k, h, w = prev.shape
    dev = prev.device
    eth, etw = th + 2 * HALO, tw + 2 * HALO
    y0, x0 = ty0 - HALO, tx0 - HALO           # extended-region origin
    wide = etw + 2 * local + 1                # columns the vertical pass makes

    # prev on the extended region plus the Scharr border, edge-replicated
    ry = torch.arange(y0 - 1, y0 + eth + 1, device=dev).clamp(0, h - 1)
    rx = torch.arange(x0 - 1, x0 + etw + 1, device=dev).clamp(0, w - 1)
    p = prev[:, ry][:, :, rx]
    sy = (3.0 * p[:, :-2] + 10.0 * p[:, 1:-1] + 3.0 * p[:, 2:]) * 0.0625
    ix = (sy[:, :, 2:] - sy[:, :, :-2]) * 0.5
    sx = (3.0 * p[:, :, :-2] + 10.0 * p[:, :, 1:-1] + 3.0 * p[:, :, 2:]) \
        * 0.0625
    iy = (sx[:, 2:] - sx[:, :-2]) * 0.5
    pw = p[:, 1:-1, 1:-1]

    # flow on the extended region; the vertical warp pass also reads fy
    # up to 2*local+1 columns right of it (edge column of the tile's ext)
    ys = torch.arange(y0, y0 + eth, device=dev)
    xs = x0 + torch.arange(wide, device=dev).clamp(max=etw - 1)
    fl = _flow_planes(cur, init, coarse_in, ys, xs, h, w, spill)
    fx, fyw = fl[:, 0, :, :etw], fl[:, 1]
    fy = fyw[:, :, :etw]

    # tile reference displacement
    if coarse_in:
        ch, cw = init.shape[-2:]
        cy = min(max((ty0 // th) * (th // 2) + (eth // 2 + 1) // 2 - 4, 0),
                 ch - 1)
        cx = min(max((tx0 // tw) * (tw // 2) + (etw // 2 + 1) // 2 - 4, 0),
                 cw - 1)
        ref = 2.0 * init[:, :, cy, cx]
    else:
        ref = cur[:, :, y0 + eth // 2, x0 + etw // 2]
    jw = warp_region(nxt, fx, fyw, y0, x0, ref, bound, local)

    r = (jw - pw) - (ix * fx + iy * fy)

    a11 = _box(ix * ix, th, tw, win_k)
    a12 = _box(ix * iy, th, tw, win_k)
    a22 = _box(iy * iy, th, tw, win_k)
    det = a11 * a22 - a12 * a12
    t = a11 - a22
    # divide by a device tensor, not a Python scalar: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal, which rounds
    # differently from the kernel's IEEE division
    area2 = torch.tensor(2.0 * win_k * win_k, dtype=torch.float32,
                         device=dev)
    min_eig = (a11 + a22 - torch.sqrt(t * t + 4.0 * a12 * a12)) / area2
    solvable = det > 1e-7
    valid = (min_eig >= thr) & solvable
    invd = valid.to(torch.float32) / torch.where(solvable, det, 1.0)

    fx_t = fx[:, HALO:HALO + th, HALO:HALO + tw]
    fy_t = fy[:, HALO:HALO + th, HALO:HALO + tw]
    b1 = _box(ix * r, th, tw, win_k) + a11 * fx_t + a12 * fy_t
    b2 = _box(iy * r, th, tw, win_k) + a12 * fx_t + a22 * fy_t
    du = (a12 * b2 - a22 * b1) * invd
    dv = (a12 * b1 - a11 * b2) * invd
    new = torch.stack([(fx_t + du).clamp(-bound, bound),
                       (fy_t + dv).clamp(-bound, bound)], dim=1)
    return new, min_eig, valid
