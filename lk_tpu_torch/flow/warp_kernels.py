"""The warp-only and precomputed-A dense levels: kernel wrappers and plain
versions.

Counterparts of two Pallas makers of ``lk_tpu/flow/pallas_kernels.py``:

* ``pallas_local_warp`` -> ``local_warp``: the standalone tile-reference
  bilinear warp of a level, used by the warp-only level
  (``DenseLKConfig(use_pallas_warp=True)``, levels below
  ``fused_from_iters``), with ``next`` stored as f32 or, as
  ``window_dtype=bfloat16`` asks (``bf16_warp_window``), rounded once to
  bf16 while the arithmetic stays f32;
* ``make_fused_lk_level`` -> ``fused_lk_level_precomputed``: ``n_iters``
  IC iterations on a precomputed prev / ix / iy / A / inv_det
  (``fused_grads_in_kernel=False``), Jacobi across tiles, no eps freeze;
  the kernel runs every iteration in one launch.

Each dispatches on the device of its inputs: CPU tensors go to the plain
version (``*_reference``), CUDA tensors to the CUDA kernel
(``lk_tpu_torch/csrc/local_warp.cu``, ``csrc/fused_level_pre.cu``), with no
fallback between the two.  Both kernels warp with ``csrc/warp_tile.cuh``,
whose plain form is ``lk_kernels.warp_region``, the warp of the
grads-fused level too; kernel and plain version agree bit for bit.

Flow is carried as (2, H, W) planes (dx, dy); H % tile_h == W % tile_w == 0
(the caller pads).  The warp window is centred on the tile's reference
displacement, the flow at the tile centre rounded half to even; the
precomputed level warps each tile's 8-pixel halo with the same reference.

The precomputed level's halo flow: inside the level the previous
iteration's flow, outside it the initial flow edge-replicated — except
that, from the second iteration on, the first ``min(8, ceil(tile_w/128)*128
- tile_w)`` columns right of the level (in the level's rows) carry the
current flow's edge column.  The TPU kernel writes 128-aligned widths, so
its rightmost tile refreshes them; the port reproduces this here, where
the 1080p precomputed-A path meets it at its top level (136x240, 6
iterations), as the tiled grads-fused level does (``lk_kernels``).
"""

from __future__ import annotations

import ctypes

import torch

from lk_tpu_torch.flow.lk_kernels import (HALO, MAX_LOCAL, _box,
                                          _flow_planes, warp_region)

# Kernel launches (one per call of each: the level runs all its iterations
# in one launch) and calls of the plain versions; the local warp's launches
# also by the storage type of its window.
kernel_launches = {"local_warp": 0, "fused_lk_level_precomputed": 0}
plain_calls = {"local_warp": 0, "fused_lk_level_precomputed": 0}
local_warp_launches_by_window = {"float32": 0, "bfloat16": 0}

# The local warp's default tile and residual range (pallas_kernels.py's
# TILE_H, TILE_W, LOCAL).
TILE_H, TILE_W, LOCAL = 64, 384, 6

# Storage types of the local warp's next plane (its window), and the C
# function that launches the kernel's instance for each.
WINDOW_DTYPES = {torch.float32: "lk_local_warp_launch",
                 torch.bfloat16: "lk_local_warp_bf16_launch"}


def reset_counters() -> None:
    for d in (kernel_launches, plain_calls, local_warp_launches_by_window):
        for k in d:
            d[k] = 0


def right_spill(tile_w: int) -> int:
    """Columns right of the level that the tiled TPU kernels' 128-aligned
    writes refresh with the current flow's edge (module docstring); only
    the halo's 8 matter."""
    return min(HALO, -(-tile_w // 128) * 128 - tile_w)


def _check_planes(named, h, w, dev, dtype=torch.float32):
    for name, t in named:
        if tuple(t.shape[-2:]) != (h, w):
            raise ValueError(f"{name} {tuple(t.shape)} is not (..., {h}, {w})")
        want = dtype if name == "next" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")


def _check_level(nxt, flow, tile_h, tile_w, local, planes=(),
                 window_dtype=torch.float32):
    if window_dtype not in WINDOW_DTYPES:
        raise TypeError(f"window_dtype {window_dtype} is not one of "
                        f"{tuple(WINDOW_DTYPES)}")
    if nxt.ndim != 2:
        raise ValueError(f"next must be (H, W), got {tuple(nxt.shape)}")
    h, w = nxt.shape
    if h % tile_h or w % tile_w:
        raise ValueError(f"level {h}x{w} is not a multiple of the tile "
                         f"{tile_h}x{tile_w}")
    if tuple(flow.shape) != (2, h, w):
        raise ValueError(f"flow shape {tuple(flow.shape)}, expected "
                         f"(2, {h}, {w})")
    if not 0 <= local <= MAX_LOCAL:
        raise ValueError(f"local {local} outside 0..{MAX_LOCAL}")
    _check_planes((("next", nxt), ("flow", flow)) + tuple(planes), h, w,
                  nxt.device, window_dtype)


def _dispatch(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


# ---------------------------------------------------------------------------
# local warp
# ---------------------------------------------------------------------------

def local_warp(nxt: torch.Tensor, flow: torch.Tensor, *, max_disp: int = 32,
               tile_h: int = TILE_H, tile_w: int = TILE_W, local: int = LOCAL,
               window_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out(p) = next(p + clip(flow(p), +-max_disp)), separable bilinear,
    per tile around its reference displacement, the residual beyond
    +-local clamped.  nxt: (H, W); flow: (2, H, W).  Returns (H, W) f32.

    ``next`` is read as ``window_dtype`` (float32 or bfloat16): a plane of
    another type is cast first, so a caller that warps one plane several
    times casts it once itself.  A bf16 plane rounds the intensities once
    (by <= 0.5 on 0..255); every operation of the warp stays f32."""
    if not _dispatch(nxt, "local_warp"):
        return local_warp_reference(nxt, flow, max_disp=max_disp,
                                    tile_h=tile_h, tile_w=tile_w, local=local,
                                    window_dtype=window_dtype)
    from lk_tpu_torch import _build

    nxt = nxt.to(window_dtype)
    _check_level(nxt, flow, tile_h, tile_w, local, window_dtype=window_dtype)
    lib = _build.library()
    nxt, flow = nxt.contiguous(), flow.contiguous()
    h, w = nxt.shape
    out = torch.empty((h, w), dtype=torch.float32, device=nxt.device)
    _build.launch(getattr(lib, WINDOW_DTYPES[window_dtype]), nxt,
                  "local_warp", nxt.data_ptr(), flow[0].data_ptr(),
                  flow[1].data_ptr(), out.data_ptr(), h, w, tile_h, tile_w,
                  local, float(max_disp))
    kernel_launches["local_warp"] += 1
    local_warp_launches_by_window[str(window_dtype).removeprefix("torch.")] \
        += 1
    return out


def local_warp_reference(nxt: torch.Tensor, flow: torch.Tensor, *,
                         max_disp: int = 32, tile_h: int = TILE_H,
                         tile_w: int = TILE_W, local: int = LOCAL,
                         window_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain PyTorch form of ``local_warp``: ``next`` cast to
    ``window_dtype`` and back to f32 (exact), then ``warp_region`` per
    tile."""
    nxt = nxt.to(window_dtype)
    _check_level(nxt, flow, tile_h, tile_w, local, window_dtype=window_dtype)
    plain_calls["local_warp"] += 1
    nxt = nxt.to(torch.float32)
    h, w = nxt.shape
    dev = nxt.device
    bound = float(max_disp)
    wide = tile_w + 2 * local + 1
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    for ty0 in range(0, h, tile_h):
        ys = torch.arange(ty0, ty0 + tile_h, device=dev)
        for tx0 in range(0, w, tile_w):
            xs = tx0 + torch.arange(wide, device=dev).clamp(max=tile_w - 1)
            fx = flow[0][ys][:, xs[:tile_w]]
            fyw = flow[1][ys][:, xs]
            ref = flow[:, ty0 + tile_h // 2, tx0 + tile_w // 2]
            out[ty0:ty0 + tile_h, tx0:tx0 + tile_w] = warp_region(
                nxt[None], fx[None], fyw[None], ty0, tx0, ref[None], bound,
                local)[0]
    return out


# ---------------------------------------------------------------------------
# precomputed-A fused level
# ---------------------------------------------------------------------------

def _pre_planes(prev, ix, iy, a11, a12, a22, inv_det):
    return (("prev", prev), ("ix", ix), ("iy", iy), ("a11", a11),
            ("a12", a12), ("a22", a22), ("inv_det", inv_det))


def _check_pre(nxt, flow, planes, tile_h, tile_w, local, n_iters, win_k):
    _check_level(nxt, flow, tile_h, tile_w, local, planes)
    if not 1 <= win_k <= 2 * HALO - 1:
        raise ValueError(f"win_k {win_k} outside 1..{2 * HALO - 1}")
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")


def fused_lk_level_precomputed(
        nxt: torch.Tensor, prev: torch.Tensor, ix: torch.Tensor,
        iy: torch.Tensor, a11: torch.Tensor, a12: torch.Tensor,
        a22: torch.Tensor, inv_det: torch.Tensor, flow: torch.Tensor, *,
        n_iters: int, max_disp: int, tile_h: int, tile_w: int, local: int,
        win_k: int = 15) -> torch.Tensor:
    """``n_iters`` IC iterations of a level on its precomputed Scharr
    gradients, structure tensor and inv_det (0 where the gate fails).
    All planes (H, W); flow: (2, H, W) initial flow.  Returns (2, H, W)."""
    if not _dispatch(nxt, "fused_lk_level_precomputed"):
        return fused_lk_level_precomputed_reference(
            nxt, prev, ix, iy, a11, a12, a22, inv_det, flow, n_iters=n_iters,
            max_disp=max_disp, tile_h=tile_h, tile_w=tile_w, local=local,
            win_k=win_k)
    return _fused_level_pre_cuda(
        nxt, prev, ix, iy, a11, a12, a22, inv_det, flow, n_iters=n_iters,
        max_disp=max_disp, tile_h=tile_h, tile_w=tile_w, local=local,
        win_k=win_k)


# Output block shapes of csrc/fused_level_pre.cu (its SHAPES), by index.
PRE_BLOCK_SHAPES = ((32, 32), (16, 32))


def _fused_level_pre_cuda(nxt, prev, ix, iy, a11, a12, a22, inv_det, flow,
                          *, n_iters, max_disp, tile_h, tile_w, local,
                          win_k=15, shape=-1, blocks_per_sm=0):
    """The kernel's launch: all ``n_iters`` in one cooperative launch that
    reads the initial flow and writes two ping-pong buffers in turn.
    ``shape`` forces ``PRE_BLOCK_SHAPES[shape]`` (-1: the kernel's
    default), ``blocks_per_sm`` caps the grid below the resident maximum
    (0: no cap); every shape and grid gives the same bits."""
    from lk_tpu_torch import _build

    planes = _pre_planes(prev, ix, iy, a11, a12, a22, inv_det)
    _check_pre(nxt, flow, planes, tile_h, tile_w, local, n_iters, win_k)
    lib = _build.library()
    nxt, init = nxt.contiguous(), flow.contiguous()
    held = [t.contiguous() for _, t in planes]  # alive until the launch
    h, w = nxt.shape
    bufs = [torch.empty((2, h, w), dtype=torch.float32, device=nxt.device)
            for _ in range(min(n_iters, 2))]
    _build.launch(
        lib.lk_fused_level_pre_launch, nxt, "fused_lk_level_precomputed",
        nxt.data_ptr(), *(t.data_ptr() for t in held), init.data_ptr(),
        bufs[0].data_ptr(), bufs[1].data_ptr() if n_iters > 1 else None,
        h, w, tile_h, tile_w, local, win_k, right_spill(tile_w), n_iters,
        float(max_disp), shape, blocks_per_sm)
    kernel_launches["fused_lk_level_precomputed"] += 1
    return bufs[(n_iters - 1) % 2]


def fused_lk_level_precomputed_reference(
        nxt: torch.Tensor, prev: torch.Tensor, ix: torch.Tensor,
        iy: torch.Tensor, a11: torch.Tensor, a12: torch.Tensor,
        a22: torch.Tensor, inv_det: torch.Tensor, flow: torch.Tensor, *,
        n_iters: int, max_disp: int, tile_h: int, tile_w: int, local: int,
        win_k: int = 15) -> torch.Tensor:
    """Plain PyTorch form of ``fused_lk_level_precomputed``: one Python
    iteration per reference tile, the kernel's operations in its order."""
    planes = _pre_planes(prev, ix, iy, a11, a12, a22, inv_det)
    _check_pre(nxt, flow, planes, tile_h, tile_w, local, n_iters, win_k)
    plain_calls["fused_lk_level_precomputed"] += 1
    h, w = nxt.shape
    dev = nxt.device
    th, tw = tile_h, tile_w
    eth, etw = th + 2 * HALO, tw + 2 * HALO
    wide = etw + 2 * local + 1
    bound = float(max_disp)
    static = torch.stack([prev, ix, iy])[:, None]       # (3, 1, H, W)
    init = cur = flow[None]                              # (1, 2, H, W)
    for it in range(n_iters):
        spill = right_spill(tw) if it else 0
        out = torch.empty((1, 2, h, w), dtype=torch.float32, device=dev)
        for ty0 in range(0, h, th):
            for tx0 in range(0, w, tw):
                y0, x0 = ty0 - HALO, tx0 - HALO       # extended-region origin
                ry = torch.arange(y0, y0 + eth, device=dev).clamp(0, h - 1)
                rx = torch.arange(x0, x0 + etw, device=dev).clamp(0, w - 1)
                pw, ixw, iyw = static[:, :, ry][..., rx]
                ys = torch.arange(y0, y0 + eth, device=dev)
                xs = x0 + torch.arange(wide, device=dev).clamp(max=etw - 1)
                fl = _flow_planes(cur, init, False, ys, xs, h, w, spill)
                fx, fyw = fl[:, 0, :, :etw], fl[:, 1]
                fy = fyw[:, :, :etw]
                ref = cur[:, :, y0 + eth // 2, x0 + etw // 2]
                jw = warp_region(nxt[None], fx, fyw, y0, x0, ref, bound,
                                 local)
                r = (jw - pw) - (ixw * fx + iyw * fy)
                t = (slice(ty0, ty0 + th), slice(tx0, tx0 + tw))
                b11, b12, b22, invd = a11[t], a12[t], a22[t], inv_det[t]
                fx_t = fx[:, HALO:HALO + th, HALO:HALO + tw]
                fy_t = fy[:, HALO:HALO + th, HALO:HALO + tw]
                b1 = _box(ixw * r, th, tw, win_k) + b11 * fx_t + b12 * fy_t
                b2 = _box(iyw * r, th, tw, win_k) + b12 * fx_t + b22 * fy_t
                du = (b12 * b2 - b22 * b1) * invd
                dv = (b12 * b1 - b11 * b2) * invd
                out[0, 0, t[0], t[1]] = (fx_t + du).clamp(-bound, bound)[0]
                out[0, 1, t[0], t[1]] = (fy_t + dv).clamp(-bound, bound)[0]
        cur = out
    return cur[0]


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interfaces of ``csrc/local_warp.cu`` and
    ``csrc/fused_level_pre.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in WINDOW_DTYPES.values():    # next f32 or bf16
        fn = getattr(lib, name)
        fn.argtypes = [
            p, p, p, p,            # next, fx, fy, out
            i, i, i, i, i,         # H, W, tile_h, tile_w, local
            f, p,                  # max_disp, stream
        ]
        fn.restype = i
    lib.lk_fused_level_pre_launch.argtypes = [
        p, p, p, p, p, p, p, p,    # next, prev, ix, iy, a11, a12, a22, inv_det
        p, p, p,                   # init, buf0, buf1
        i, i, i, i, i, i, i, i,    # H, W, tile_h, tile_w, local, win_k,
                                   # spill, n_iters
        f, i, i, p,                # max_disp, shape, blocks_per_sm, stream
    ]
    lib.lk_fused_level_pre_launch.restype = i
