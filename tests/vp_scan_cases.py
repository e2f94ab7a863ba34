"""Inputs of the VP pair scan (``geometry.vanishing.process_frame_pairs``)
for the tests that hold its CUDA kernel to its plain version: states of
every kind the scan meets and candidate sets of every fill, made with
numpy from a seed.  Imports neither JAX nor cv2
(the card's machine has neither)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lk_tpu_torch.geometry.vanishing import (FrameGeomOut, VPState,
                                             init_vp_state, vp_show_step)
from lk_tpu_torch.models import PRESETS

SIZE = (860, 483)                # (W, H): cp_thold bounds of 57.3, 32.2 px
# fresh; ring filling (ring_total < vp_ref_num); initialized with an
# aliased slot in, at the edge of and out of the ring's window;
# vp_init_aliasing off; just hidden by vp_show_step
STATES = ("fresh", "mid_fill", "aliased", "no_aliasing", "just_hidden")
CANDS = ("none", "all", "mixed")


def scan_config(state_kind: str, ring: int = 15):
    """The final preset with ``ring`` CP slots (vp_ref_num); no aliasing
    for the ``no_aliasing`` states."""
    cfg = dataclasses.replace(PRESETS["final"], vp_ref_num=ring)
    if state_kind == "no_aliasing":
        cfg = dataclasses.replace(cfg, vp_init_aliasing=False)
    return cfg


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def scan_state(kind: str, cfg, b: int, rng) -> VPState:
    """B streams' VP state of one kind, on the CPU."""
    r, h = cfg.vp_ref_num, cfg.vp_ref
    fresh = init_vp_state(cfg, b, device="cpu")
    if kind == "fresh":
        return fresh
    vp = rng.uniform([300, 150], [560, 250], (b, 2))
    ring = vp[:, None] + rng.normal(0, 4, (b, r, 2))
    hist = vp[:, None] + rng.normal(0, 2, (b, h, 2))
    hist_total = rng.integers(0, 2 * h + 50, b)
    if kind == "mid_fill":
        return fresh._replace(
            ring_xy=_f32(ring), ring_total=_i64(rng.integers(1, r, b)),
            hist_xy=_f32(hist), hist_total=_i64(hist_total))
    total = rng.integers(r, 3 * r, b)
    # the aliased append index: the newest, the oldest in the window, one
    # out of it, none, one inside
    alias = total - np.array([1, r, r + 1, 0, 3])[np.arange(b) % 5]
    alias[np.arange(b) % 5 == 3] = -1
    init = np.ones(b, bool)
    if kind == "no_aliasing":
        # half the streams initialized with no alias, half two appends
        # short of their first VP
        init = np.arange(b) % 2 == 0
        alias[:] = -1
        total = np.where(init, total, r - 2)
    state = VPState(
        vp_xy=_f32(np.where(init[:, None], vp, 0.0)),
        vp_init=torch.from_numpy(init),
        vp_moved=torch.from_numpy(init & (rng.random(b) < 0.5)),
        ring_xy=_f32(ring), ring_total=_i64(total), alias_pos=_i64(alias),
        vp_ult=_i64(rng.integers(0, 8, b)), hist_xy=_f32(hist),
        hist_total=_i64(hist_total))
    if kind == "just_hidden":
        # every stream but each fourth past hide_vp_thold, then the frame's
        # show/hide block: those hide, the rest show
        ult = np.where(np.arange(b) % 4 == 3, 0, cfg.hide_vp_thold + 1)
        state = state._replace(vp_ult=_i64(ult))
        empty = FrameGeomOut(*(torch.zeros(1) for _ in FrameGeomOut._fields))
        state, _ = vp_show_step(state, empty, cfg)
    return state


def scan_candidates(kind: str, state: VPState, p: int, rng):
    """(cps (B, P, 2), cand (B, P)) with the candidates first, as
    ``frame_candidates`` orders them: most near the stream's VP (or a
    centre), some within the close bound's reach, some far; NaN and far
    values in the slots past the candidates."""
    b = state.vp_xy.shape[0]
    if kind == "none":
        n_cand = np.zeros(b, np.int64)
    elif kind == "all":
        n_cand = np.full(b, p, np.int64)
    else:
        n_cand = rng.integers(0, p + 1, b)
        n_cand[:3] = [max(p // 2, 1), 0, p][:b]
    centre = np.where(state.vp_init.numpy()[:, None],
                      state.vp_xy.numpy(), rng.uniform(300, 500, (b, 2)))
    spread = rng.choice([3.0, 25.0, 300.0], (b, p, 1), p=[0.7, 0.2, 0.1])
    cps = centre[:, None] + rng.normal(0, 1, (b, p, 2)) * spread
    # some cross points exactly on the VP: zero differences
    on_vp = rng.random((b, p)) < 0.05
    cps[on_vp] = np.broadcast_to(centre[:, None], (b, p, 2))[on_vp]
    cand = np.arange(p)[None] < n_cand[:, None]
    rest = ~cand & (rng.random((b, p)) < 0.3)
    cps[rest] = np.nan
    return _f32(cps), torch.from_numpy(cand)


def scan_case(state_kind: str, cand_kind: str, b: int, p: int, seed: int,
              ring: int = 15, device="cpu"):
    """(cfg, state, cps, cand, size) of one case on ``device``."""
    rng = np.random.default_rng(seed)
    cfg = scan_config(state_kind, ring)
    state = scan_state(state_kind, cfg, b, rng)
    cps, cand = scan_candidates(cand_kind, state, p, rng)
    state = VPState(*(x.to(device) for x in state))
    return cfg, state, cps.to(device), cand.to(device), SIZE


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32: -0 is not
    +0, and NaN equals NaN of the same payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())
