"""Pipeline state and outputs of the VP pipeline: counterpart of
``lk_tpu.pipeline.state``.

The batched pipeline's leaves carry a leading stream axis B (the batched
runner's layout in ``lk_tpu`` after its ``vmap``); the single-stream
pipeline's have lk_tpu's single-stream shapes, without it
(``with_stream_axis`` / ``without_stream_axis`` convert).
``state_from_numpy`` takes ``lk_tpu``'s state, fetched to numpy, to the
port's batched layout, so both packages can run on from the same state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.geometry.vanishing import VPState, init_vp_state


class PipelineState(NamedTuple):
    """Shapes as the batched pipeline holds them; the single-stream
    pipeline's leaves lack the leading B."""
    prev_gray: torch.Tensor   # (B, H, W) f32 — processed previous frame
    pts: torch.Tensor         # (B, G, S, 2) f32 tracking-point slots
    valid: torch.Tensor       # (B, G, S) bool
    avg_len: torch.Tensor     # (B, G) f32 EMA average flow length
    vp: VPState
    tp_ult: torch.Tensor      # (B,) int64 frames since last replenish


class FrameOutputs(NamedTuple):
    """Per-frame outputs (fixed shapes, masked); the runner stacks them to
    (B, T, ...)."""
    update_rows: torch.Tensor   # (P, 2) VP after each in-frame update
    update_mask: torch.Tensor   # (P,)
    show_row: torch.Tensor      # (2,)
    show_mask: torch.Tensor     # ()
    vp_hidden: torch.Tensor     # ()
    cp_xy: torch.Tensor         # (P, 2) accepted cross points
    cp_mask: torch.Tensor       # (P,)
    line_start: torch.Tensor    # (L, 2) flow lines (draw_mask)
    line_stop: torch.Tensor     # (L, 2)
    line_mask: torch.Tensor     # (L,)
    pts: torch.Tensor           # (G, S, 2) tracked points
    pts_valid: torch.Tensor     # (G, S)
    live_count: torch.Tensor    # ()
    vp_xy: torch.Tensor         # (2,) current VP (post-frame)
    vp_init: torch.Tensor       # ()
    motion_labels: torch.Tensor  # (L,) int32 per-line motion class
    motion_fracs: torch.Tensor  # (4,) static/away/toward/lateral fractions


class RowSpill(NamedTuple):
    """A chunk's uncompacted row fields, (B, T, P, ...) as ``FrameOutputs``
    stacks them."""
    update_rows: torch.Tensor
    update_mask: torch.Tensor
    cp_xy: torch.Tensor
    cp_mask: torch.Tensor


class CompactChunkOutputs(NamedTuple):
    """Chunk outputs with the pair-capacity rows compacted
    (``PipelineConfig.out_cap``): the masked update rows and accepted cross
    points of all T frames moved, in (frame, slot) order, to the front of a
    ``T * out_cap`` buffer, with exact per-frame counts.  The host
    reconstructs the identical row streams.  ``spill`` keeps the
    uncompacted rows on the device until the drain: a stream whose chunk
    emitted more rows than the budget holds is read from it instead, so
    the budget bounds what the host usually reads, never what it gets."""
    upd_rows: torch.Tensor    # (B, K, 2) f32
    upd_counts: torch.Tensor  # (B, T) — rows per frame (exact, pre-cap)
    cp_rows: torch.Tensor     # (B, K, 2) f32
    cp_counts: torch.Tensor   # (B, T)
    rest: FrameOutputs        # the row/CP fields and overlay fields emptied
    spill: Optional[RowSpill] = None


def slots_per_group(cfg: PipelineConfig) -> int:
    return cfg.tp_num // cfg.num_groups


def init_pipeline_state(first_gray: torch.Tensor,
                        cfg: PipelineConfig) -> PipelineState:
    """Zeroed state of B streams around their first processed frames
    (B, H, W), on the frames' device; the runner's detection seeds the
    points."""
    b = first_gray.shape[0]
    g, s = cfg.num_groups, slots_per_group(cfg)
    dev = first_gray.device
    return PipelineState(
        prev_gray=first_gray.to(torch.float32),
        pts=torch.zeros((b, g, s, 2), dtype=torch.float32, device=dev),
        valid=torch.zeros((b, g, s), dtype=torch.bool, device=dev),
        avg_len=torch.full((b, g), cfg.min_fl_len, dtype=torch.float32,
                           device=dev),
        vp=init_vp_state(cfg, b, device=dev),
        tp_ult=torch.zeros((b,), dtype=torch.int64, device=dev),
    )


def with_stream_axis(tree):
    """A single-stream state or outputs (NamedTuple of tensors, nested)
    as a batch of one stream."""
    if isinstance(tree, torch.Tensor):
        return tree[None]
    return type(tree)(*(with_stream_axis(x) for x in tree))


def without_stream_axis(tree):
    """The one stream of a batch of one, with single-stream shapes."""
    if isinstance(tree, torch.Tensor):
        if tree.shape[:1] != (1,):
            raise ValueError(f"a batch of one stream expected, got a leaf "
                             f"of shape {tuple(tree.shape)}")
        return tree[0]
    return type(tree)(*(without_stream_axis(x) for x in tree))


def _leaf(x, dtype, device, batched: bool) -> torch.Tensor:
    t = torch.from_numpy(np.array(x)).to(dtype)
    if not batched:
        t = t[None]
    return t.to(device)


def state_from_numpy(leaves: dict, cfg: PipelineConfig,
                     device="cuda") -> PipelineState:
    """The port's ``PipelineState`` on ``device`` from ``lk_tpu``'s, fetched
    to numpy: ``jax.device_get(state)._asdict()``, with ``vp`` a
    ``VPState`` (or its ``_asdict()``).  A batched state (the batched
    runner's, leading stream axis) keeps its axis; a single-stream state
    gains one of size 1."""
    g, s = cfg.num_groups, slots_per_group(cfg)
    pts = np.asarray(leaves["pts"])
    if pts.shape[-3:] != (g, s, 2):
        raise ValueError(f"pts {pts.shape} do not match the config's "
                         f"({g}, {s}) slots")
    batched = pts.ndim == 4
    vp = leaves["vp"]
    vp = vp if isinstance(vp, dict) else vp._asdict()
    f32, i64 = torch.float32, torch.int64
    vp_dtypes = dict(vp_xy=f32, vp_init=torch.bool, vp_moved=torch.bool,
                     ring_xy=f32, ring_total=i64, alias_pos=i64, vp_ult=i64,
                     hist_xy=f32, hist_total=i64)
    return PipelineState(
        prev_gray=_leaf(leaves["prev_gray"], f32, device, batched),
        pts=_leaf(pts, f32, device, batched),
        valid=_leaf(leaves["valid"], torch.bool, device, batched),
        avg_len=_leaf(leaves["avg_len"], f32, device, batched),
        vp=VPState(**{k: _leaf(vp[k], dt, device, batched)
                      for k, dt in vp_dtypes.items()}),
        tp_ult=_leaf(leaves["tp_ult"], i64, device, batched),
    )
