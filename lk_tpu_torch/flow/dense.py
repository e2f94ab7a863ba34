"""Dense pyramidal Lucas–Kanade optical flow (PyTorch port).

Counterpart of ``lk_tpu/flow/dense.py`` with the same names, the same
configs (the port's copy, ``lk_tpu_torch.config``) and the same numerics
contract: the window-coherent inverse-compositional formulation,
coarse-to-fine.  A level runs one of three forms, chosen per level as
``lk_tpu`` chooses them:

* the grads-fused level (``use_pallas_fused`` or ``use_pallas_warp`` with
  ``fused_grads_in_kernel``): ``lk_kernels.fused_lk_level``;
* the precomputed-A level (``fused_grads_in_kernel=False`` at levels that
  fuse): Scharr, A and the gate in plain PyTorch on the tile-padded level,
  then ``warp_kernels.fused_lk_level_precomputed``;
* the masked-iteration level (no fused kernel): the same prologue, then
  ``outer_iters`` rounds of warp, residual, box sums and solve with the
  per-pixel eps freeze, the warp being ``warp_kernels.local_warp`` under
  ``use_pallas_warp`` and ``ops.warp.shift_select_warp`` otherwise (the
  default config's XLA level: unpadded, plain PyTorch throughout).

Functions that take tensors run where their inputs are (the tensor's
device is the caller's choice): CPU tensors through the plain PyTorch
versions, CUDA tensors through the hand-written CUDA kernels (the levels
above and the pyramid, ``build_pyramid``).  The one entry point that takes
numpy, ``levels_from_numpy``, puts its tensors on the card
(``device="cuda"``) unless the caller names another device.

What the TPU layout needed and this port drops: the unified pad layouts
(borders are read by clamped address, so levels stay unpadded), the
alignment gate of the pyrDown pair kernel (the port's takes any shape) and
the bf16 trades inside the TPU kernels (``scharr_mxu``, ``fast_pyramid``,
the MXU box sums): the port computes their exact f32 form.
``padded_build`` builds the video's pyramid with no intermediate level
copies; the port's one-launch build already does (the base pad folded in),
so it runs that build and gives the same bits, and refuses, as ``lk_tpu``,
without ``fast_pyramid``.

On the card ``dense_pyramidal_lk`` replays its pyramid and its levels down
to level 1 as one CUDA graph per key (shapes, types, device, stream,
configs), then launches level 0 op by op into fresh outputs;
``pair_graph_counts`` counts captures, replays and op-by-op calls.

The two bf16 options of the masked-iteration and precomputed-A levels are
ported as ``lk_tpu`` applies them: ``bf16_box_sums`` takes the three A
sums and the per-iteration b sums in bf16 (``box_sum(sum_dtype=)``), and
``bf16_warp_window`` rounds ``next`` to bf16 once per level call for the
local warp (``local_warp(window_dtype=)``; the precomputed-A level's warp
stays f32).  The grads-fused level ignores both, as in ``lk_tpu``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import NamedTuple, Optional

import torch

from lk_tpu_torch.config import DenseLKConfig, LKConfig
from lk_tpu_torch.flow.lk_kernels import (fused_lk_level, pick_tile_w,
                                          HALO)
from lk_tpu_torch.flow.warp_kernels import (fused_lk_level_precomputed,
                                            local_warp)
from lk_tpu_torch.ops.blur import build_pyramid, edge_pad
from lk_tpu_torch.ops.boxfilter import box_sum
from lk_tpu_torch.ops.gradients import scharr_derivatives
from lk_tpu_torch.ops.resize import upsample2_linear
from lk_tpu_torch.ops.warp import shift_select_warp
from lk_tpu_torch.utils.profiling import span

# lk_tpu/flow/dense.py _build_levels_padded's assertion, word for word
_PADDED_BUILD_NEEDS_FAST = (
    "padded_build implements the fast (banded-matmul) decimation; "
    "set fast_pyramid=True or padded_build=False")
# OpenCV's fixed-point A is ours / 1024: its default minEigThreshold maps to
# min_eig_threshold * 1024 on the normalized-gradient scale.
_MIN_EIG_SCALE = 1024.0

def _effective_cfg(
    cfg: LKConfig, dense_cfg: DenseLKConfig,
    hw: tuple[int, int] | None = None,
) -> LKConfig:
    """Apply DenseLKConfig.pyramid_levels to cfg.max_level, then clamp the
    depth so the top level stays at least the window size (floor shifts,
    exactly as ``lk_tpu``: the plan depth must agree with it)."""
    lv = dense_cfg.pyramid_levels
    if lv and lv - 1 != cfg.max_level:
        cfg = dataclasses.replace(cfg, max_level=lv - 1)
    if hw is not None:
        h, w = hw
        win_w, win_h = cfg.win_size
        ml = cfg.max_level
        while ml > 0 and ((h >> ml) < win_h or (w >> ml) < win_w):
            ml -= 1
        if ml != cfg.max_level:
            cfg = dataclasses.replace(cfg, max_level=ml)
    return cfg


class DenseFlowResult(NamedTuple):
    flow: torch.Tensor      # (..., H, W, 2) float32, (dx, dy)
    min_eig: torch.Tensor   # (..., H, W) float32, min eigenvalue / area
    valid: torch.Tensor     # (..., H, W) bool — structure tensor solvable


def pallas_level_geometry(
    h0: int, w0: int, dense_cfg: DenseLKConfig
) -> tuple[bool, int, int, int, int]:
    """(grads_resident, tile_h, tile_w, padded_h, padded_w) of a level.

    The TPU tile choice, kept because the reference tiles are part of the
    numerics (each warps with its own reference displacement)."""
    grads_resident = (
        dense_cfg.use_pallas_fused and dense_cfg.fused_grads_in_kernel
        and -(-h0 // 8) * 8 <= min(dense_cfg.fused_resident_max_h, 272)
        and w0 <= 512
    )
    if grads_resident:
        th = -(-h0 // 8) * 8
    elif dense_cfg.use_pallas_fused and dense_cfg.fused_grads_in_kernel:
        if dense_cfg.fused_tile_h:
            th = min(dense_cfg.fused_tile_h, -(-h0 // 8) * 8)
        else:
            hc = -(-h0 // 8) * 8
            cands = [min(hc, t) for t in (272, 136, 64)]
            best_pad = min(-(-h0 // t) * t for t in cands)
            th = next(t for t in cands if -(-h0 // t) * t == best_pad)
    elif dense_cfg.use_pallas_fused and h0 <= 272:
        th = min(-(-h0 // 8) * 8, 136)
    else:
        th = 64
    tw, wp = pick_tile_w(w0)
    if (not grads_resident and dense_cfg.use_pallas_fused
            and dense_cfg.fused_grads_in_kernel):
        if dense_cfg.fused_tile_w:
            tw = min(dense_cfg.fused_tile_w, -(-w0 // 128) * 128)
            wp = -(-w0 // tw) * tw
        elif w0 > 512:
            for cand in (512, 384, 256):
                if cand <= tw:
                    break
                wp_c = -(-w0 // cand) * cand
                if wp_c - w0 <= (wp - w0) + 128:
                    tw, wp = cand, wp_c
                    break
    hp = -(-h0 // th) * th
    return grads_resident, th, tw, hp, wp


def dense_lk_level(
    prev: torch.Tensor,
    next_: torch.Tensor,
    flow_init: Optional[torch.Tensor],
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
    max_disp: int | None = None,
    coarse_planes_init: Optional[torch.Tensor] = None,
    planes_out: bool = False,
) -> DenseFlowResult:
    """One pyramid level of window-coherent dense LK, in the form the config
    picks (module docstring).

    prev/next_: (H, W).  flow_init: (H, W, 2), or None with
    coarse_planes_init (2, H/2, W/2) — the coarser level's flow planes,
    upsampled inside the grads-fused level.  planes_out returns flow as
    (2, H, W) (grads-fused level only).  Under ``use_pallas_*`` the level
    is edge-padded to its tile geometry and cropped after."""
    r_disp = dense_cfg.max_disp if max_disp is None else max_disp
    prev = prev.to(torch.float32)
    next_ = next_.to(torch.float32)
    h0, w0 = prev.shape[-2:]
    if dense_cfg.use_pallas_fused and dense_cfg.fused_grads_in_kernel:
        return _grads_fused_level(prev, next_, flow_init, cfg, dense_cfg,
                                  r_disp, coarse_planes_init, planes_out)
    if coarse_planes_init is not None or planes_out:
        raise ValueError("plane-layout I/O needs the grads-fused level")
    flow = flow_init.to(torch.float32).movedim(-1, 0)
    tiled = dense_cfg.use_pallas_warp or dense_cfg.use_pallas_fused
    if tiled:
        _, th, tw, hp, wp = pallas_level_geometry(h0, w0, dense_cfg)
        prev, next_, flow = (edge_pad(x, hp, wp)
                             for x in (prev, next_, flow))

    # the fused kernel's b sums see edge-replicated halos, so its A does too
    win = cfg.win_size
    sums = torch.bfloat16 if dense_cfg.bf16_box_sums else torch.float32
    ix, iy, a11, a12, a22, min_eig, valid, inv_det = level_prologue(
        prev, cfg, "edge" if dense_cfg.use_pallas_fused else "zero", sums)

    if dense_cfg.use_pallas_fused:
        flow = fused_lk_level_precomputed(
            next_, prev, ix, iy, a11, a12, a22, inv_det, flow.contiguous(),
            n_iters=dense_cfg.outer_iters, max_disp=r_disp, tile_h=th,
            tile_w=tw, local=dense_cfg.warp_local, win_k=win[1])
    else:
        bound = float(r_disp)
        eps2 = cfg.eps * cfg.eps
        active = torch.ones_like(valid)
        window = (torch.bfloat16 if dense_cfg.bf16_warp_window
                  else torch.float32)
        if dense_cfg.use_pallas_warp:        # rounded once per level call
            next_ = next_.to(window)
        for _ in range(dense_cfg.outer_iters):
            if dense_cfg.use_pallas_warp:
                jw = local_warp(next_, flow, max_disp=r_disp, tile_h=th,
                                tile_w=tw, local=dense_cfg.warp_local,
                                window_dtype=window)
            else:
                jw = shift_select_warp(next_, flow.movedim(0, -1),
                                       (r_disp, r_disp))
            fx, fy = flow[0], flow[1]
            r = (jw - prev) - (ix * fx + iy * fy)
            b1 = box_sum(ix * r, win, sum_dtype=sums) + a11 * fx + a12 * fy
            b2 = box_sum(iy * r, win, sum_dtype=sums) + a12 * fx + a22 * fy
            du = (a12 * b2 - a22 * b1) * inv_det
            dv = (a12 * b1 - a11 * b2) * inv_det
            flow = torch.where(active & valid, flow + torch.stack([du, dv]),
                               flow).clamp(-bound, bound)
            active = active & (du * du + dv * dv > eps2)
    return DenseFlowResult(flow=flow[:, :h0, :w0].movedim(0, -1),
                           min_eig=min_eig[:h0, :w0], valid=valid[:h0, :w0])


def level_prologue(prev: torch.Tensor, cfg: LKConfig, border: str,
                   sum_dtype: torch.dtype = torch.float32):
    """lk_tpu's XLA prologue of a level: Scharr (ix, iy) of prev, the
    structure tensor (a11, a12, a22) as box sums with ``border`` taken in
    ``sum_dtype``, min_eig (over the window area), the gate ``valid`` and
    ``inv_det`` (0 where the gate fails)."""
    win = cfg.win_size
    ix, iy = scharr_derivatives(prev)
    a11 = box_sum(ix * ix, win, border=border, sum_dtype=sum_dtype)
    a12 = box_sum(ix * iy, win, border=border, sum_dtype=sum_dtype)
    a22 = box_sum(iy * iy, win, border=border, sum_dtype=sum_dtype)
    det = a11 * a22 - a12 * a12
    t = a11 - a22
    min_eig = ((a22 + a11) - torch.sqrt(t * t + 4.0 * a12 * a12)) / (
        2.0 * float(win[0] * win[1]))
    valid = ((min_eig >= cfg.min_eig_threshold * _MIN_EIG_SCALE)
             & (det > 1e-7))
    inv_det = torch.where(valid, 1.0 / det, 0.0)
    return ix, iy, a11, a12, a22, min_eig, valid, inv_det


def _grads_fused_level(prev, next_, flow_init, cfg, dense_cfg, r_disp,
                       coarse_planes_init, planes_out) -> DenseFlowResult:
    """The grads-fused level: ``fused_lk_level`` on the tile-padded level."""
    win_w, win_h = cfg.win_size
    if win_w != win_h:
        raise ValueError("the fused level needs a square window")
    h0, w0 = prev.shape[-2:]
    grads_resident, th, tw, hp, wp = pallas_level_geometry(h0, w0, dense_cfg)
    if grads_resident and coarse_planes_init is not None:
        raise ValueError("the resident level takes no coarse input")
    if coarse_planes_init is not None:
        if (hp, wp) != (h0, w0):
            raise ValueError("coarse-chain levels must be pad-free")
        flow_in = coarse_planes_init.to(torch.float32)
    else:
        flow_in = edge_pad(flow_init.to(torch.float32).movedim(-1, 0),
                            hp, wp)
    flow, min_eig, valid = fused_lk_level(
        edge_pad(prev, hp, wp)[None], edge_pad(next_, hp, wp)[None],
        flow_in[None].contiguous(), tile_h=th, tile_w=tw, max_disp=r_disp,
        local=dense_cfg.warp_local, n_iters=dense_cfg.outer_iters,
        coarse_in=coarse_planes_init is not None,
        min_eig_threshold=cfg.min_eig_threshold, win_k=win_h,
        resident=grads_resident)
    flow = flow[0, :, :h0, :w0]
    return DenseFlowResult(
        flow=flow if planes_out else flow.movedim(0, -1),
        min_eig=min_eig[0, :h0, :w0], valid=valid[0, :h0, :w0])


def dense_pyramidal_lk_batched(
    prev: torch.Tensor,
    next_: torch.Tensor,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> torch.Tensor:
    """Batched dense flow via row-folding: (B, H, W) pairs -> (B, H, W, 2).

    As ``lk_tpu``: the batch is folded into the row axis with per-frame
    edge-replicated guard bands wide enough that no level's stencil (warp
    displacement + window + gradient) crosses a frame seam, and the folded
    frame runs ``dense_pyramidal_lk``.  Box sums near a frame's top and
    bottom see replicated rows instead of the unbatched path's borders."""
    b, h, w = prev.shape
    cfg = _effective_cfg(cfg, dense_cfg, (h, w))
    top = cfg.max_level
    win_h = cfg.win_size[1]
    need = max((dense_cfg.level_disp(lv) + win_h // 2 + 4) << lv
               for lv in range(top + 1))
    mult = 1 << top
    # per-frame rows a multiple of 2**top, so decimation keeps frames aligned
    h_pad = -(-h // mult) * mult
    g = -(-need // mult) * mult
    rows = torch.arange(-g, h_pad + g, device=prev.device).clamp(0, h - 1)

    def fold(x):
        return x.index_select(1, rows).reshape(b * (h_pad + 2 * g), w)

    folded = dense_pyramidal_lk(fold(prev), fold(next_), cfg,
                                dense_cfg=dense_cfg)
    return folded.flow.reshape(b, h_pad + 2 * g, w, 2)[:, g:g + h]


def _upsample_flow(planes: torch.Tensor, dst_h: int, dst_w: int
                   ) -> torch.Tensor:
    return upsample2_linear(planes, dst_h, dst_w) * 2.0


def dense_pyramidal_lk(
    prev: torch.Tensor,
    next_: torch.Tensor,
    cfg: LKConfig = LKConfig(),
    init_flow: Optional[torch.Tensor] = None,
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Coarse-to-fine dense LK over one (H, W) pair; returns level-0 flow.

    The two pyramids are built as one (2, H, W) stack: one
    ``build_pyramid`` call (one kernel launch on the card) for the pair,
    its base edge-padded to ``pyramid_base_geometry`` under
    ``pallas_pyramid``.  On the card, with no ``init_flow`` and no stream
    capture under way, the pyramid and the levels down to level 1 replay
    as one CUDA graph (``_pair_graph``); level 0 runs after it into fresh
    outputs, so no result shares memory with the graph.  The call is the
    span ``dense.pair``."""
    with span("dense.pair"):
        if init_flow is None and prev.is_cuda:
            with torch.cuda.device(prev.device):
                if not torch.cuda.is_current_stream_capturing():
                    return _pair_graph(prev, next_, cfg, dense_cfg)
        pair_graph_counts["eager"] += 1
        return _pair_eager(prev, next_, cfg, dense_cfg, init_flow)


def _pair_eager(prev, next_, cfg, dense_cfg, init_flow) -> DenseFlowResult:
    """``dense_pyramidal_lk`` op by op."""
    cfg = _effective_cfg(cfg, dense_cfg, prev.shape[-2:])
    h_true, w_true = prev.shape[-2:]
    pair = build_frame_levels(
        torch.stack([prev.to(torch.float32), next_.to(torch.float32)]),
        cfg, dense_cfg)
    return dense_flow_from_levels(
        [lv[0] for lv in pair], [lv[1] for lv in pair], cfg, dense_cfg,
        (h_true, w_true), init_flow=init_flow)


# ---------------------------------------------------------------------------
# The per-pair program as a CUDA graph
# ---------------------------------------------------------------------------

# Keys whose graph ``dense_pyramidal_lk`` keeps; the least recently used
# goes first, and its memory pool with it.
PAIR_GRAPHS = 8

# ``dense_pyramidal_lk`` calls by how they ran: ``captures`` (a key's graph
# captured), ``replays`` (a graph replayed, the capturing call's too) and
# ``eager`` (op by op: a key's first call and every call the graph does not
# take).  The graph's hit share is replays / (replays + eager).  The kernel
# wrappers count the launches they make: a capture's, and level 0's on
# every call; a replay's other launches show in a device trace only.
pair_graph_counts = {"captures": 0, "replays": 0, "eager": 0}

_pair_graphs: collections.OrderedDict = collections.OrderedDict()
_pair_graphs_lock = threading.Lock()
_capture_lock = threading.Lock()     # one capture at a time in the process


def reset_counters() -> None:
    for k in pair_graph_counts:
        pair_graph_counts[k] = 0


class _PairProgram:
    """One key's graph: the static pair it reads, and its level 0 (the
    call ``_coarse_levels`` returned while capturing)."""

    def __init__(self):
        self.lock = threading.Lock()   # copy-in to level 0's launch
        self.pair = None               # made by the key's first call
        self.graph = None
        self.finest = None

    def capture(self, hw, cfg, dense_cfg) -> None:
        """Capture the pyramid and the levels top..1 from ``self.pair``, on
        a side stream.  ``torch.cuda.graph``'s synchronize, garbage
        collection and ``empty_cache`` are left out: they would empty the
        whole process's allocator cache for one key."""
        cfg = _effective_cfg(cfg, dense_cfg, hw)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                levels = build_frame_levels(self.pair, cfg, dense_cfg)
                finest = _coarse_levels(
                    [lv[0] for lv in levels], [lv[1] for lv in levels], cfg,
                    dense_cfg, hw)
            finally:
                graph.capture_end()
        self.graph, self.finest = graph, finest
        pair_graph_counts["captures"] += 1


def _pair_graph(prev, next_, cfg, dense_cfg) -> DenseFlowResult:
    """``dense_pyramidal_lk`` through its key's graph, on the current
    device.  The key: the inputs' shapes, types and device, the current
    stream and both configs.  A key's first call runs op by op, so the
    kernel library is built and the launchers' caches (occupancy,
    shared-memory attributes) are filled outside any capture.  The second
    captures, and it and every later call copy the pair in, replay, and
    launch level 0.  A caller that rebinds a name this module looks up at
    call time clears ``_pair_graphs`` around it."""
    key = (prev.shape, next_.shape, prev.dtype, next_.dtype,
           prev.device.index, torch.cuda.current_stream().cuda_stream, cfg,
           dense_cfg)
    with _pair_graphs_lock:
        prog = _pair_graphs.get(key)
        if prog is None:
            prog = _pair_graphs[key] = _PairProgram()
            while len(_pair_graphs) > PAIR_GRAPHS:
                _pair_graphs.popitem(last=False)
        else:
            _pair_graphs.move_to_end(key)
    with prog.lock:
        if prog.pair is None:
            result = _pair_eager(prev, next_, cfg, dense_cfg, None)
            prog.pair = torch.empty((2, *prev.shape), dtype=torch.float32,
                                    device=prev.device)
            pair_graph_counts["eager"] += 1
            return result
        torch.stack([prev.to(torch.float32), next_.to(torch.float32)],
                    out=prog.pair)
        if prog.graph is None:
            prog.capture(prev.shape[-2:], cfg, dense_cfg)
        prog.graph.replay()
        pair_graph_counts["replays"] += 1
        return prog.finest()


def pyramid_base_geometry(
    h_true: int, w_true: int, cfg: LKConfig, dense_cfg: DenseLKConfig
) -> tuple[int, int]:
    """Padded pyramid-base geometry under ``pallas_pyramid`` (1080x1920 ->
    1088x2048 in production), taken only when the video plan accepts it."""
    cfg = _effective_cfg(cfg, dense_cfg, (h_true, w_true))
    if not (dense_cfg.pallas_pyramid and cfg.max_level > 0):
        return h_true, w_true
    n0 = dense_cfg.level_iters(0)
    fuse0 = dense_cfg.use_pallas_fused or (
        dense_cfg.use_pallas_warp
        and (dense_cfg.fused_grads_in_kernel
             or n0 >= dense_cfg.fused_from_iters))
    if fuse0 or dense_cfg.use_pallas_warp:
        l0_cfg = dataclasses.replace(
            dense_cfg, outer_iters=n0, use_pallas_fused=fuse0,
            warp_local=dense_cfg.level_local(0),
            fused_resident_max_h=0)
        _, _, _, hp, wp = pallas_level_geometry(h_true, w_true, l0_cfg)
    else:
        hp, wp = h_true, w_true
    hp = -(-hp // 16) * 16
    if (hp, wp) != (h_true, w_true) and _video_level_plan(
            cfg, dense_cfg, (hp, wp), true_hw=(h_true, w_true)) is None:
        return h_true, w_true
    return hp, wp


def build_frame_levels(
    frame: torch.Tensor,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> tuple:
    """Pyramid levels of a frame, or of a (N, H, W) stack of frames: the
    base edge-padded to ``pyramid_base_geometry``, then ``pyr_down`` per
    level, as one ``build_pyramid`` call.  That build materializes no
    intermediate level, so ``padded_build`` changes nothing here."""
    cfg = _effective_cfg(cfg, dense_cfg, frame.shape[-2:])
    h_true, w_true = frame.shape[-2:]
    hp, wp = pyramid_base_geometry(h_true, w_true, cfg, dense_cfg)
    return build_pyramid(frame, cfg.max_level, (hp, wp))


def _check_padded_build(dense_cfg: DenseLKConfig) -> None:
    """The video plan's build refuses ``padded_build`` without
    ``fast_pyramid``, where and as ``lk_tpu`` does."""
    if dense_cfg.padded_build and not dense_cfg.fast_pyramid:
        raise ValueError(_PADDED_BUILD_NEEDS_FAST)


class _LevelPlan(NamedTuple):
    """Static per-level geometry of the video chain."""
    h: int
    w: int
    th: int
    tw: int
    resident: bool
    iters: int
    local: int
    disp: int


def _video_level_plan(
    cfg: LKConfig, dense_cfg: DenseLKConfig, base_hw: tuple[int, int],
    true_hw: tuple[int, int] | None = None,
) -> Optional[tuple]:
    """Per-level geometry of the video chain, or None when the config or
    geometry cannot run it (the caller then takes the per-call path).

    Accept/reject exactly as ``lk_tpu``: every level pad-free at its tile
    geometry, the top level one resident tile, every finer level a
    single-iteration coarse-chain consumer with th % 16 == 0 and
    tw % 256 == 0.  ``lk_tpu``'s unified pad tuple is not carried: the
    port reads borders by clamped address."""
    cfg = _effective_cfg(cfg, dense_cfg, true_hw or base_hw)
    if not (dense_cfg.use_pallas_warp or dense_cfg.use_pallas_fused):
        return None
    if not dense_cfg.fused_grads_in_kernel or not dense_cfg.fused_coarse_chain:
        return None
    top = cfg.max_level
    if cfg.win_size[0] != cfg.win_size[1]:
        return None
    hs, ws = [base_hw[0]], [base_hw[1]]
    for _ in range(top):
        if hs[-1] % 2 or ws[-1] % 2:
            return None
        hs.append(hs[-1] // 2)
        ws.append(ws[-1] // 2)
    plan = []
    for level in range(top + 1):
        n_it = dense_cfg.level_iters(level)
        local = dense_cfg.level_local(level)
        disp = dense_cfg.level_disp(level)
        lcfg = dataclasses.replace(
            dense_cfg, outer_iters=n_it, use_pallas_fused=True,
            warp_local=local,
            fused_resident_max_h=(dense_cfg.fused_resident_max_h
                                  if level == top else 0))
        g_res, th, tw, hp, wp = pallas_level_geometry(hs[level], ws[level],
                                                      lcfg)
        if (hp, wp) != (hs[level], ws[level]):
            return None
        if level == top:
            if not g_res:
                return None
            th, tw = hs[level], ws[level]
        else:
            if g_res or n_it != 1 or th % 16 or tw % 256:
                return None
        plan.append(_LevelPlan(hs[level], ws[level], th, tw,
                               level == top, n_it, local, disp))
    return tuple(plan)


def _unified_pad_geometry(tile_h: int, tile_w: int, max_disp: int,
                          local: int) -> tuple[int, int, int, int]:
    """(top, bottom, left, right) pads of ``lk_tpu``'s unified prepadded
    level layout (pallas_kernels.unified_pad_geometry), for stripping."""
    eth, etw = tile_h + 2 * HALO, tile_w + 2 * HALO
    sh = -(-(eth + 2 * local + 8) // 8) * 8
    sw = 128
    while sw < etw + 2 * local + 1 + 127:
        sw *= 2
    pad_t = max_disp + local + HALO + 8
    pad_b = max_disp + local + (sh - eth) + HALO + 16
    pad_r = max_disp + local + (sw - etw) + HALO + 16
    etw_dma_p = -(-(tile_w + 128 + HALO + 1) // 128) * 128
    pt = -(-max(pad_t, 16) // 8) * 8
    return pt, max(pad_b, 16), 128, max(pad_r, etw_dma_p - tile_w - 128)


def levels_from_numpy(levels, plan: tuple, device="cuda") -> tuple:
    """The carried state across the two packages: ``lk_tpu``'s unified
    prepadded pyramid levels (numpy, (..., Hp, Wp) per level) with the pads
    stripped, as this port's unpadded levels on ``device``."""
    if len(levels) != len(plan):
        raise ValueError(f"{len(levels)} levels for a {len(plan)}-level plan")
    out = []
    for arr, p in zip(levels, plan):
        pt, pb, pl, pr = _unified_pad_geometry(p.th, p.tw, p.disp, p.local)
        if arr.shape[-2:] != (pt + p.h + pb, pl + p.w + pr):
            raise ValueError(f"level shape {arr.shape} does not match the "
                             f"plan entry {p}")
        core = arr[..., pt:pt + p.h, pl:pl + p.w]
        out.append(torch.as_tensor(core.copy(), dtype=torch.float32,
                                   device=device))
    return tuple(out)


def _plan_levels(prev: tuple, nxt: tuple, cfg: LKConfig, plan: tuple,
                 true_hw: tuple[int, int], seed: Optional[torch.Tensor] = None):
    """The video plan's levels, top to 0, over K pairs: prev/nxt hold per
    level (K, h, w) stacks of the pairs' first and second frames, and each
    level is one fused-level call over the K pairs (the same per-pixel
    arithmetic whatever K), the top one from ``seed`` (K, 2, h_top, w_top;
    None: zeros).  Returns the result, with level 0's (min_eig, valid),
    and the top level's converged flow (K, h_top, w_top, 2)."""
    h_true, w_true = true_hw
    top = cfg.max_level
    flow = seed
    if seed is None:
        flow = torch.zeros((prev[top].shape[0], 2, plan[top].h, plan[top].w),
                           dtype=torch.float32, device=prev[top].device)
    for level in range(top, -1, -1):
        p = plan[level]
        flow, min_eig, valid = fused_lk_level(
            prev[level], nxt[level], flow, tile_h=p.th, tile_w=p.tw,
            max_disp=p.disp, local=p.local, n_iters=p.iters,
            coarse_in=level < top, write_stats=level == 0,
            min_eig_threshold=cfg.min_eig_threshold, win_k=cfg.win_size[1])
        if level == top:
            top_flow = flow.movedim(1, -1)
    result = DenseFlowResult(
        flow=flow[:, :, :h_true, :w_true].movedim(1, -1),
        min_eig=min_eig[:, :h_true, :w_true],
        valid=valid[:, :h_true, :w_true],
    )
    return result, top_flow


def dense_flow_from_levels_prepadded(
    prev_levels: tuple,
    next_levels: tuple,
    cfg: LKConfig,
    dense_cfg: DenseLKConfig,
    true_hw: tuple[int, int],
    plan: tuple,
    init_flow: Optional[torch.Tensor] = None,
    return_top_flow: bool = False,
):
    """Coarse-to-fine refinement of one pair along the video plan.

    prev_levels/next_levels: per-level (h, w) planes at the plan sizes (the
    port carries them unpadded).  The top level runs as one resident tile,
    every finer level consumes the coarser flow as half-resolution planes;
    only level 0 writes (min_eig, valid).  init_flow seeds the top level
    ((h_top, w_top, 2)); return_top_flow also returns its converged flow."""
    cfg = _effective_cfg(cfg, dense_cfg, true_hw)
    p = plan[cfg.max_level]
    seed = None
    if init_flow is not None:
        if tuple(init_flow.shape) != (p.h, p.w, 2):
            raise ValueError(f"init_flow shape {tuple(init_flow.shape)}")
        seed = init_flow.to(torch.float32).movedim(-1, 0)[None].contiguous()
    result, top_flow = _plan_levels(
        tuple(x[None] for x in prev_levels),
        tuple(x[None] for x in next_levels), cfg, plan, true_hw, seed)
    result = DenseFlowResult(*(x[0] for x in result))
    return (result, top_flow[0]) if return_top_flow else result


def dense_flow_chunk_prepadded(
    frames_chunk: torch.Tensor,
    cfg: LKConfig,
    dense_cfg: DenseLKConfig,
    true_hw: tuple[int, int],
    plan: tuple,
) -> DenseFlowResult:
    """Dense flow over a chunk of K+1 frames (K cold pairs), each level one
    fused-level call over all K pairs.  frames_chunk: (K+1, H, W).

    Per pair bit-identical to the per-frame chain: the level runs the same
    per-pixel arithmetic whatever K, and ``build_pyramid`` is elementwise over
    the frame axis.  The call is the span ``dense.chunk``."""
    with span("dense.chunk"):
        cfg = _effective_cfg(cfg, dense_cfg, true_hw)
        top = cfg.max_level
        if len(plan) != top + 1:
            raise ValueError(f"{len(plan)}-level plan for max_level {top}")
        _check_padded_build(dense_cfg)
        stacks = build_frame_levels(frames_chunk, cfg, dense_cfg)
        for st, p in zip(stacks, plan):
            if tuple(st.shape[1:]) != (p.h, p.w):
                raise ValueError(f"level {tuple(st.shape)} does not match {p}")
        return _plan_levels(tuple(st[:-1] for st in stacks),
                            tuple(st[1:] for st in stacks), cfg, plan,
                            true_hw)[0]


def _stack(results: list) -> DenseFlowResult:
    return DenseFlowResult(*(torch.stack(x) for x in zip(*results)))


def _cat(parts: list) -> DenseFlowResult:
    return DenseFlowResult(*(torch.cat(x) for x in zip(*parts)))


def dense_pyramidal_lk_video(
    frames: torch.Tensor,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Dense pyramidal LK over a video: (T, H, W) -> flows (T-1, H, W, 2).

    Each frame's pyramid is built once and carried to the next pair.  With
    ``video_chunk`` > 1 (and no warm start) pairs run in chunks of that
    many cold pairs, the leftover pairs as one shorter chunk.  With
    ``video_warm_start`` the top level of each pair after the first is
    seeded with the previous pair's converged top flow and runs
    ``warm_top_iters``.  The call is the span ``dense.video``; in it, the
    chunks' ``dense.chunk`` and the output copy's ``dense.cat``."""
    with span("dense.video"):
        if frames.ndim != 3 or frames.shape[0] < 2:
            raise ValueError(f"frames must be (T >= 2, H, W), got "
                             f"{tuple(frames.shape)}")
        h_true, w_true = frames.shape[-2:]
        hw = (h_true, w_true)
        cfg = _effective_cfg(cfg, dense_cfg, hw)
        t_total = frames.shape[0]
        plan = _video_level_plan(
            cfg, dense_cfg,
            pyramid_base_geometry(h_true, w_true, cfg, dense_cfg), true_hw=hw)
        chunk = dense_cfg.video_chunk
        if plan is not None and chunk > 1 and not dense_cfg.video_warm_start:
            parts = [dense_flow_chunk_prepadded(
                frames[c:c + chunk + 1], cfg, dense_cfg, hw, plan)
                for c in range(0, t_total - 1, chunk)]
            with span("dense.cat"):
                return _cat(parts)

        def chain(levels_a, levels_b, d_cfg, pl, seed=None, want_top=False):
            if pl is not None:
                return dense_flow_from_levels_prepadded(
                    levels_a, levels_b, cfg, d_cfg, hw, pl, init_flow=seed,
                    return_top_flow=want_top)
            return dense_flow_from_levels(
                levels_a, levels_b, cfg, d_cfg, hw, init_flow=seed,
                return_top_flow=want_top)

        warm_cfg = warm_plan = None
        if dense_cfg.video_warm_start and t_total > 2:
            warm_cfg = dataclasses.replace(
                dense_cfg,
                iter_schedule=tuple(dense_cfg.level_iters(lv)
                                    for lv in range(cfg.max_level))
                + (dense_cfg.warm_top_iters,))
            if plan is not None:
                warm_plan = _video_level_plan(
                    cfg, warm_cfg,
                    pyramid_base_geometry(h_true, w_true, cfg, warm_cfg),
                    true_hw=hw)
                if warm_plan is None:  # lk_tpu falls back to the per-call
                    plan = None        # chain for the whole warm video
        if plan is not None:
            _check_padded_build(dense_cfg)
        levels = build_frame_levels(frames[0], cfg, dense_cfg)
        results = []
        seed = None
        for t in range(1, t_total):
            nxt = build_frame_levels(frames[t], cfg, dense_cfg)
            if warm_cfg is None:
                results.append(chain(levels, nxt, dense_cfg, plan))
            elif t == 1:       # cold first pair seeds the warm chain
                res, seed = chain(levels, nxt, dense_cfg, plan,
                                  want_top=True)
                results.append(res)
            else:
                res, seed = chain(levels, nxt, warm_cfg, warm_plan,
                                  seed=seed, want_top=True)
                results.append(res)
            levels = nxt
        return _stack(results)


def dense_pyramidal_lk_multistream(
    frames: torch.Tensor,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Dense video flow over N independent streams: (N, T, H, W) -> flows
    (N, T-1, H, W, 2), one stream after the other."""
    if frames.ndim != 4:
        raise ValueError(f"frames must be (N, T, H, W), got "
                         f"{tuple(frames.shape)}")
    return _stack([dense_pyramidal_lk_video(fr, cfg, dense_cfg)
                   for fr in frames])


def level_configs(dense_cfg: DenseLKConfig, top: int) -> list:
    """The per-level configs of the per-call chain, level 0 first: each
    level's iterations and warp range, and whether it fuses (levels of at
    least ``fused_from_iters`` iterations switch to the fused kernel under
    ``use_pallas_warp``); only the top level may be resident."""
    cfgs = []
    for level in range(top + 1):
        n_it = dense_cfg.level_iters(level)
        fuse = dense_cfg.use_pallas_fused or (
            dense_cfg.use_pallas_warp
            and (dense_cfg.fused_grads_in_kernel
                 or n_it >= dense_cfg.fused_from_iters)
        )
        cfgs.append(dataclasses.replace(
            dense_cfg, outer_iters=n_it, use_pallas_fused=fuse,
            warp_local=dense_cfg.level_local(level),
            fused_resident_max_h=(dense_cfg.fused_resident_max_h
                                  if level == top else 0),
        ))
    return cfgs


def dense_flow_from_levels(
    prev_levels,
    next_levels,
    cfg: LKConfig,
    dense_cfg: DenseLKConfig,
    true_hw: tuple[int, int],
    init_flow: Optional[torch.Tensor] = None,
    return_top_flow: bool = False,
):
    """Coarse-to-fine refinement over prebuilt pyramid levels (the per-call
    path: each level padded to its tile geometry inside dense_lk_level).

    init_flow seeds the top level ((h, w, 2), edge-padded if sized for the
    unpadded top); return_top_flow also returns the converged top flow.
    Levels top..1 run first, then level 0 (``_coarse_levels``): the split
    along which ``dense_pyramidal_lk`` replays its CUDA graph."""
    return _coarse_levels(prev_levels, next_levels,
                          _effective_cfg(cfg, dense_cfg, true_hw), dense_cfg,
                          true_hw, init_flow, return_top_flow)()


def _coarse_levels(prev_levels, next_levels, cfg: LKConfig,
                   dense_cfg: DenseLKConfig, true_hw: tuple[int, int],
                   init_flow: Optional[torch.Tensor] = None,
                   return_top_flow: bool = False):
    """``dense_flow_from_levels``'s levels top..1 (``cfg`` already through
    ``_effective_cfg``).  Returns its level 0 as a call: each call launches
    level 0 from what the coarse levels left, into fresh outputs, and gives
    what ``dense_flow_from_levels`` returns."""
    h_true, w_true = true_hw
    top = cfg.max_level
    h_top, w_top = prev_levels[top].shape[-2:]
    dev = prev_levels[top].device
    if init_flow is None:
        flow = torch.zeros((h_top, w_top, 2), dtype=torch.float32,
                           device=dev)
    else:
        flow = init_flow.to(torch.float32)
        if tuple(flow.shape[:2]) != (h_top, w_top):
            flow = edge_pad(flow.movedim(-1, 0), h_top, w_top).movedim(0, -1)

    level_cfgs = level_configs(dense_cfg, top)

    def _grads_path(level: int) -> bool:
        c = level_cfgs[level]
        return c.use_pallas_fused and c.fused_grads_in_kernel

    coarse_ok = [False] * (top + 1)
    for level in range(top if dense_cfg.fused_coarse_chain else 0):
        c = level_cfgs[level]
        if not (_grads_path(level) and _grads_path(level + 1)
                and c.outer_iters == 1):
            continue
        h, w = prev_levels[level].shape[-2:]
        h2, w2 = prev_levels[level + 1].shape[-2:]
        if (h2, w2) != (h // 2, w // 2):
            continue
        g_res, th, tw, hp, wp = pallas_level_geometry(h, w, c)
        coarse_ok[level] = (not g_res and (hp, wp) == (h, w)
                            and th % 16 == 0 and tw % 256 == 0)

    def step(level: int, flow: torch.Tensor, planes: bool) -> tuple:
        """One level from the coarser level's ``flow`` (in the (2, h, w)
        plane layout when ``planes``): (its result, whether its flow is in
        the plane layout)."""
        use_coarse = level != top and coarse_ok[level] and planes
        if level != top and not use_coarse:
            h, w = prev_levels[level].shape[-2:]
            if not planes:
                flow = flow.movedim(-1, 0)
            flow = _upsample_flow(flow, h, w).movedim(0, -1)
        want_planes = level > 0 and coarse_ok[level - 1]
        result = dense_lk_level(
            prev_levels[level], next_levels[level],
            None if use_coarse else flow, cfg, level_cfgs[level],
            max_disp=dense_cfg.level_disp(level),
            coarse_planes_init=flow if use_coarse else None,
            planes_out=want_planes,
        )
        return result, want_planes

    top_flow = None
    planes = False     # whether `flow` carries (2, h, w) plane layout
    for level in range(top, 0, -1):
        result, planes = step(level, flow, planes)
        flow = result.flow
        if level == top and return_top_flow:
            top_flow = flow.movedim(0, -1) if planes else flow

    def finest():
        result, _ = step(0, flow, planes)
        finest_top = result.flow if top == 0 else top_flow
        if tuple(result.flow.shape[:2]) != (h_true, w_true):
            result = DenseFlowResult(
                flow=result.flow[:h_true, :w_true],
                min_eig=result.min_eig[:h_true, :w_true],
                valid=result.valid[:h_true, :w_true],
            )
        if return_top_flow:
            return result, finest_top
        return result

    return finest
