"""The vanishing-point state machine over a batch of streams: counterpart of
``lk_tpu.geometry.vanishing`` (``VPState``, ``init_vp_state``,
``process_frame_pairs``, ``vp_show_step``, ``vanishing_lines``), with its
quirks:

* the VP can update once per accepted cross point, each update reading the
  ring of the last ``vp_ref_num`` CPs including the one just appended, so
  the pairs of a frame are processed in sequence;
* robust update: component-wise mean +- std * ``max_cp_std`` clip of the
  CP-to-VP differences, mean of the kept ones scaled by ``vp_update_rate``;
* init: once ``vp_ref_num`` CPs accumulate, VP = their mean; with
  ``vp_init_aliasing`` the ring entry appended last reads as the current VP
  until it leaves the window (LK_Final.py:617-624);
* hide/reset after ``hide_vp_thold`` frames without an update;
* cross points that compute to nan are rejected;
* vanishing lines: x->y and y->x least squares over the VP-history ring
  (scipy.stats.linregress in the reference, LK_Final.py:219-238).

Every leaf of ``VPState`` has a leading stream axis (B, ...).  The pair
scan is sequential per stream.  ``process_frame_pairs`` dispatches on the
device of its inputs: a CPU tensor goes to ``process_frame_pairs_reference``
(plain PyTorch), which walks the candidate pairs of all B streams together
up to the largest candidate count, masking the streams that are done (a
step past a stream's last candidate changes nothing of it); a CUDA tensor
goes to the kernel ``lk_tpu_torch/csrc/vp_scan.cu``, one launch for the B
streams, each walking its own candidates, with no fallback between the
two.  Both give the same bits on the card (the kernel takes the plain
version's operations in their order, the ring sums in the order of
PyTorch's CUDA reduction).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.geometry.crosspoints import cross_point_pairs, pair_indices
from lk_tpu_torch.geometry.flowlines import FlowLineStats


class VPState(NamedTuple):
    vp_xy: torch.Tensor        # (B, 2) f32
    vp_init: torch.Tensor      # (B,) bool
    vp_moved: torch.Tensor     # (B,) bool
    ring_xy: torch.Tensor      # (B, vp_ref_num, 2) recent-CP ring
    ring_total: torch.Tensor   # (B,) int64 — appends since last clear
    alias_pos: torch.Tensor    # (B,) int64 — append index aliased, -1 none
    vp_ult: torch.Tensor       # (B,) int64 — frames since last VP update
    hist_xy: torch.Tensor      # (B, vp_ref, 2) VP-history ring
    hist_total: torch.Tensor   # (B,) int64


class FrameGeomOut(NamedTuple):
    """Per-frame geometry outputs (fixed shapes, masked), (B, ...)."""
    update_rows: torch.Tensor   # (B, P, 2) VP after each in-frame update
    update_mask: torch.Tensor   # (B, P)
    cp_xy: torch.Tensor         # (B, P, 2) accepted cross points
    cp_mask: torch.Tensor       # (B, P)
    show_row: torch.Tensor      # (B, 2)
    show_mask: torch.Tensor     # (B,)
    vp_hidden: torch.Tensor     # (B,)


def init_vp_state(cfg: PipelineConfig, batch: int,
                  device="cuda") -> VPState:
    """Fresh state of ``batch`` streams on ``device``."""
    f32, i64 = torch.float32, torch.int64

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return VPState(
        vp_xy=z((batch, 2), f32), vp_init=z((batch,), torch.bool),
        vp_moved=z((batch,), torch.bool),
        ring_xy=z((batch, cfg.vp_ref_num, 2), f32),
        ring_total=z((batch,), i64),
        alias_pos=torch.full((batch,), -1, dtype=i64, device=device),
        vp_ult=z((batch,), i64), hist_xy=z((batch, cfg.vp_ref, 2), f32),
        hist_total=z((batch,), i64),
    )


def _ring_slots(total: torch.Tensor, capacity: int):
    """Per-slot absolute append index (largest a < total with a%cap == k)
    of (B,) totals -> (B, capacity)."""
    k = torch.arange(capacity, device=total.device)
    t = total[:, None]
    abs_idx = t - 1 - torch.remainder(t - 1 - k, capacity)
    return abs_idx, (abs_idx >= 0) & (t > 0)


def _set_slot(ring: torch.Tensor, slot: torch.Tensor, value: torch.Tensor,
              do: torch.Tensor) -> torch.Tensor:
    """ring[b, slot[b]] = value[b] where do[b]."""
    hit = (torch.arange(ring.shape[1], device=ring.device)[None, :]
           == slot[:, None]) & do[:, None]
    return torch.where(hit[..., None], value[:, None, :], ring)


def frame_candidates(lines: FlowLineStats, accepted: torch.Tensor,
                     cfg: PipelineConfig, frame_size: Tuple[int, int]):
    """The frame's cross points in scan order: (cps (B, P, 2), cand
    (B, P)) with the candidate pairs moved stably to the front, as
    ``lk_tpu``'s argsort compaction."""
    width, _ = frame_size
    ii, jj = pair_indices(lines.start.shape[-2], lines.start.device)
    cps = cross_point_pairs(lines.start, lines.stop)
    ang_d = (lines.angle[:, ii] - lines.angle[:, jj]).abs()
    pair_ok = (accepted[:, ii] & accepted[:, jj] & (ang_d >= cfg.min_ang_dif)
               & (ang_d <= 360.0 - cfg.min_ang_dif))
    if cfg.cp_min_start_sep_frac > 0:
        sep = (lines.start[:, ii, 0] - lines.start[:, jj, 0]).abs()
        pair_ok = pair_ok & (sep >= width * cfg.cp_min_start_sep_frac)
    not_nan = ~(torch.isnan(cps[..., 0]) | torch.isnan(cps[..., 1]))
    above = ((cps[..., 1] <= lines.start[:, ii, 1])
             & (cps[..., 1] <= lines.start[:, jj, 1]))
    cand = pair_ok & not_nan & above
    order = torch.argsort((~cand).to(torch.uint8), dim=1, stable=True)
    cps_c = cps.gather(1, order[..., None].expand_as(cps))
    return cps_c, cand.gather(1, order)


# Kernel launches of the CUDA pair scan, and calls of the plain version.
kernel_launches = 0
plain_calls = 0


def reset_counters() -> None:
    global kernel_launches, plain_calls
    kernel_launches = plain_calls = 0


def _check(state: VPState, cps_c: torch.Tensor, cand_c: torch.Tensor,
           cfg: PipelineConfig) -> None:
    if cand_c.ndim != 2 or tuple(cps_c.shape) != (*cand_c.shape, 2):
        raise ValueError(f"the pair scan takes (B, P, 2) cross points and "
                         f"(B, P) candidates, got {tuple(cps_c.shape)} and "
                         f"{tuple(cand_c.shape)}")
    b, p = cand_c.shape
    f32, i64, flag = torch.float32, torch.int64, torch.bool
    want = dict(
        cps_c=(cps_c, (b, p, 2), f32), cand_c=(cand_c, (b, p), flag),
        vp_xy=(state.vp_xy, (b, 2), f32), vp_init=(state.vp_init, (b,), flag),
        vp_moved=(state.vp_moved, (b,), flag),
        ring_xy=(state.ring_xy, (b, cfg.vp_ref_num, 2), f32),
        ring_total=(state.ring_total, (b,), i64),
        alias_pos=(state.alias_pos, (b,), i64),
        vp_ult=(state.vp_ult, (b,), i64),
        hist_xy=(state.hist_xy, (b, cfg.vp_ref, 2), f32),
        hist_total=(state.hist_total, (b,), i64))
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"pair scan: {name} is {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.dtype != dtype:
            raise TypeError(f"pair scan: {name} is {x.dtype}, expected "
                            f"{dtype}")
        if x.device != cps_c.device:
            raise ValueError(f"pair scan: {name} on {x.device}, the cross "
                             f"points on {cps_c.device}")


def process_frame_pairs(state: VPState, cps_c: torch.Tensor,
                        cand_c: torch.Tensor, cfg: PipelineConfig,
                        frame_size: Tuple[int, int]
                        ) -> Tuple[VPState, FrameGeomOut]:
    """The cross-point / VP-update scan of one frame for B streams.

    ``cps_c``/``cand_c`` come from ``frame_candidates``; a stream's steps
    are its candidate pairs.  Rows past a stream's candidates stay zero
    and unmasked, as the JAX while loop leaves them.  The input state is
    not written: the new one is returned."""
    if cps_c.device.type == "cpu":
        return process_frame_pairs_reference(state, cps_c, cand_c, cfg,
                                             frame_size)
    if cps_c.device.type != "cuda":
        raise ValueError(f"process_frame_pairs: unsupported device "
                         f"{cps_c.device}")
    return _process_frame_pairs_cuda(state, cps_c, cand_c, cfg, frame_size)


def process_frame_pairs_reference(state: VPState, cps_c: torch.Tensor,
                                  cand_c: torch.Tensor,
                                  cfg: PipelineConfig,
                                  frame_size: Tuple[int, int]
                                  ) -> Tuple[VPState, FrameGeomOut]:
    """Plain PyTorch form of ``process_frame_pairs``: the B streams step
    together up to the largest candidate count, which it reads from the
    device (its one host read: this version is not captured in a CUDA
    graph)."""
    global plain_calls
    _check(state, cps_c, cand_c, cfg)
    plain_calls += 1
    width, height = frame_size
    b, p = cand_c.shape
    n_steps = int(cand_c.sum(dim=1).max()) if b else 0
    r_cap = cfg.vp_ref_num
    dev = cps_c.device
    # constants made on the device (no host copy: a CUDA graph captures it)
    f32 = dict(dtype=torch.float32, device=dev)
    bound = torch.stack([torch.full((), width * cfg.cp_thold, **f32),
                         torch.full((), height * cfg.cp_thold, **f32)])
    rate = cfg.vp_update_rate
    s_clip = cfg.max_cp_std
    r_cap_f = torch.full((), float(r_cap), **f32)
    rows = torch.zeros((b, p, 2), dtype=torch.float32, device=dev)
    cp_out = torch.zeros((b, p, 2), dtype=torch.float32, device=dev)
    row_mask = torch.zeros((b, p), dtype=torch.bool, device=dev)
    cp_mask = torch.zeros((b, p), dtype=torch.bool, device=dev)
    st = state
    for i in range(n_steps):
        cp, ok = cps_c[:, i], cand_c[:, i]
        close = ((st.vp_xy - cp).abs() < bound).all(dim=-1)
        accept = ok & (~st.vp_init | close)

        slot = torch.remainder(st.ring_total, r_cap)
        ring_xy = _set_slot(st.ring_xy, slot, cp, accept)
        ring_total = st.ring_total + accept.to(torch.int64)

        # --- update branch (VP initialized) ------------------------------
        abs_idx, slot_valid = _ring_slots(ring_total, r_cap)
        aliased = (abs_idx == st.alias_pos[:, None]) \
            & (st.alias_pos[:, None] >= 0)
        vals = torch.where(aliased[..., None], st.vp_xy[:, None, :], ring_xy)
        m = slot_valid.sum(dim=1).clamp(min=1).to(torch.float32)[:, None]
        difs = vals - st.vp_xy[:, None, :]
        w_mask = slot_valid[..., None].to(torch.float32)
        mean = (difs * w_mask).sum(dim=1) / m
        var = ((difs - mean[:, None, :]) ** 2 * w_mask).sum(dim=1) / m
        std = torch.sqrt(var)
        keep = (slot_valid
                & (difs <= (mean + std * s_clip)[:, None, :]).all(dim=-1)
                & (difs >= (mean - std * s_clip)[:, None, :]).all(dim=-1))
        c = keep.sum(dim=1)
        move = (difs * keep[..., None]).sum(dim=1) \
            / c.clamp(min=1)[:, None].to(torch.float32)
        do_update = accept & st.vp_init & (c != 0)
        new_vp_upd = st.vp_xy + move * rate

        # --- init branch ---------------------------------------------------
        do_init = accept & ~st.vp_init & (ring_total >= r_cap)
        init_vp = ring_xy.sum(dim=1) / r_cap_f

        vp_xy = torch.where(do_update[:, None], new_vp_upd,
                            torch.where(do_init[:, None], init_vp, st.vp_xy))
        alias_new = ring_total - 1 if cfg.vp_init_aliasing \
            else torch.full_like(ring_total, -1)
        hist_slot = torch.remainder(st.hist_total, cfg.vp_ref)
        st = VPState(
            vp_xy=vp_xy,
            vp_init=st.vp_init | do_init,
            vp_moved=st.vp_moved | do_update,
            ring_xy=ring_xy,
            ring_total=ring_total,
            alias_pos=torch.where(do_init, alias_new, st.alias_pos),
            vp_ult=torch.where(do_update | do_init, 0, st.vp_ult),
            hist_xy=_set_slot(st.hist_xy, hist_slot, vp_xy, do_update),
            hist_total=st.hist_total + do_update.to(torch.int64),
        )
        # ok[b] <=> i < n_cand[b] (candidates sorted first)
        rows[:, i] = torch.where(ok[:, None], vp_xy, 0.0)
        row_mask[:, i] = do_update
        cp_out[:, i] = torch.where(ok[:, None], cp, 0.0)
        cp_mask[:, i] = accept
    out = FrameGeomOut(
        update_rows=rows, update_mask=row_mask, cp_xy=cp_out, cp_mask=cp_mask,
        show_row=torch.zeros((b, 2), dtype=torch.float32, device=dev),
        show_mask=torch.zeros((b,), dtype=torch.bool, device=dev),
        vp_hidden=torch.zeros((b,), dtype=torch.bool, device=dev),
    )
    return st, out


class _ScanArgs(ctypes.Structure):
    """``LkVpScanArgs`` of ``csrc/vp_scan.cu``, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            *VPState._fields, *(f"o_{k}" for k in VPState._fields),
            "cps", "cand",
            *FrameGeomOut._fields)]
        + [(n, ctypes.c_int) for n in ("B", "P", "R", "H", "aliasing")]
        + [(n, ctypes.c_float) for n in ("bound_x", "bound_y", "rate",
                                         "clip", "r_cap")])


def _process_frame_pairs_cuda(state: VPState, cps_c: torch.Tensor,
                              cand_c: torch.Tensor, cfg: PipelineConfig,
                              frame_size: Tuple[int, int]
                              ) -> Tuple[VPState, FrameGeomOut]:
    global kernel_launches
    from lk_tpu_torch import _build

    _check(state, cps_c, cand_c, cfg)
    b, p = cand_c.shape
    width, height = frame_size
    state = VPState(*(x.contiguous() for x in state))
    cps_c, cand_c = cps_c.contiguous(), cand_c.contiguous()
    new = VPState(*(torch.empty_like(x) for x in state))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=cps_c.device)

    f32, flag = torch.float32, torch.bool
    out = FrameGeomOut(
        update_rows=empty((b, p, 2), f32), update_mask=empty((b, p), flag),
        cp_xy=empty((b, p, 2), f32), cp_mask=empty((b, p), flag),
        show_row=empty((b, 2), f32), show_mask=empty((b,), flag),
        vp_hidden=empty((b,), flag))
    args = _ScanArgs(
        *(x.data_ptr() for x in (*state, *new, cps_c, cand_c, *out)),
        b, p, cfg.vp_ref_num, cfg.vp_ref, int(cfg.vp_init_aliasing),
        width * cfg.cp_thold, height * cfg.cp_thold, cfg.vp_update_rate,
        cfg.max_cp_std, float(cfg.vp_ref_num))
    lib = _build.library()
    # the launcher refuses a ring of more than 64 slots, or more pairs than
    # a block's shared memory stages; launch() raises on that
    _build.launch(lib.lk_vp_scan_launch, cps_c, "vp_scan",
                  ctypes.byref(args))
    kernel_launches += 1
    return new, out


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C interface of ``csrc/vp_scan.cu``."""
    lib.lk_vp_scan_launch.argtypes = [ctypes.POINTER(_ScanArgs),
                                      ctypes.c_void_p]
    lib.lk_vp_scan_launch.restype = ctypes.c_int


def vp_show_step(state: VPState, out: FrameGeomOut, cfg: PipelineConfig
                 ) -> Tuple[VPState, FrameGeomOut]:
    """The per-frame show/hide block (reference LK_Final.py:627-649); runs
    after ``process_frame_pairs`` and increments ``vp_ult``."""
    hide = state.vp_init & (state.vp_ult > cfg.hide_vp_thold)
    show = state.vp_init & ~hide
    hist_slot = torch.remainder(state.hist_total, cfg.vp_ref)
    new_state = VPState(
        vp_xy=torch.where(hide[:, None], 0.0, state.vp_xy),
        vp_init=state.vp_init & ~hide,
        vp_moved=state.vp_moved & ~hide,
        ring_xy=state.ring_xy,
        ring_total=torch.where(hide, 0, state.ring_total),
        alias_pos=torch.where(hide, -1, state.alias_pos),
        vp_ult=state.vp_ult + 1,
        hist_xy=_set_slot(state.hist_xy, hist_slot, state.vp_xy, show),
        hist_total=state.hist_total + show.to(torch.int64),
    )
    return new_state, out._replace(show_row=state.vp_xy, show_mask=show,
                                   vp_hidden=hide)


def vanishing_lines(state: VPState, cfg: PipelineConfig,
                    frame_size: Tuple[int, int]):
    """Vanishing-line endpoints through each stream's VP (reference
    LK_Final.py:219-238).

    Returns ((lp, rp, up, dp), ok), each endpoint (B, 2) and ok (B,):
    lp/rp from the x->y regression over the valid history slots, extended
    to the left/right frame borders through the VP; up/dp from the y->x
    regression to the top/bottom borders.  ok: the VP has moved and both
    slopes are finite (lk_tpu's reading of the reference's ``best_point``
    mode)."""
    width, height = frame_size
    _, valid = _ring_slots(state.hist_total, cfg.vp_ref)
    w = valid.to(torch.float32)
    m_count = valid.sum(dim=1).clamp(min=1).to(torch.float32)
    xs, ys = state.hist_xy[..., 0], state.hist_xy[..., 1]
    mx = (xs * w).sum(dim=1) / m_count
    my = (ys * w).sum(dim=1) / m_count
    dx, dy = xs - mx[:, None], ys - my[:, None]
    cov = (dx * dy * w).sum(dim=1)
    varx = (dx ** 2 * w).sum(dim=1)
    vary = (dy ** 2 * w).sum(dim=1)
    slope = cov / varx           # x -> y
    slope_v = cov / vary         # y -> x
    bx, by = state.vp_xy[:, 0], state.vp_xy[:, 1]
    zero, right, bottom = (torch.full_like(bx, v)
                           for v in (0.0, width - 1.0, height - 1.0))
    lp = torch.stack([zero, by - bx * slope], -1)
    rp = torch.stack([right, by + ((width - 1) - bx) * slope], -1)
    up = torch.stack([bx - by * slope_v, zero], -1)
    dp = torch.stack([bx + ((height - 1) - by) * slope_v, bottom], -1)
    ok = state.vp_moved & torch.isfinite(slope) & torch.isfinite(slope_v)
    return (lp, rp, up, dp), ok
