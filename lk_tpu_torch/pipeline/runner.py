"""Batched serving: counterpart of ``lk_tpu.pipeline.runner``'s batched path
(``_cached_finish``, ``_compact_masked_rows``, ``_compact_chunk_outputs``,
``make_batched_chunk_runner``, the staged feed and ``MultiStreamPipeline``
with its per-stream sinks).

A chunk is a Python loop over its T frames with the whole stream batch in
each step (``lk_tpu``'s ``lax.scan``); the JAX package's ``jit`` caches
become ``functools.lru_cache``'d builders of masks and steps, keyed by the
frozen configs.  On the card the finish is the CUDA kernel of
``ops/finish.py`` and the tracker's gather that of ``flow/sparse.py``;
with tensors on the CPU, their plain versions.

Not ported here (ROADMAP.md Queue 1, the serving slice's remainder): the
single-stream ``VideoPipeline.feed``/``run`` and ``make_chunk_runner``,
``MultiStreamPipeline.feed`` (raw BGR with a host preprocess), ``mesh``,
``start_async_drains``, checkpoints and prefetch.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.flow.sparse import fold_tracking_levels
from lk_tpu_torch.ops import finish as _finish_ops
from lk_tpu_torch.ops.rasterize import build_roi_masks
from lk_tpu_torch.ops.resize import resize_area
from lk_tpu_torch.pipeline.state import (CompactChunkOutputs, FrameOutputs,
                                         PipelineState, init_pipeline_state)
from lk_tpu_torch.pipeline.step import make_step, tracker_row_band


def _cached_finish(cfg: PipelineConfig):
    """The serving finish of (..., H, W) u8/f32 frames: one ``fused_finish``
    call over all of them (``PipelineConfig.pallas_finish`` is ignored:
    the device of the frames picks kernel or plain version)."""

    def finish(g: torch.Tensor) -> torch.Tensor:
        lead = g.shape[:-2]
        out = _finish_ops.fused_finish(g.reshape((-1,) + g.shape[-2:]),
                                       contrast=cfg.contrast_enhance)
        return out.reshape(lead + out.shape[-2:])

    return finish


def _compact_masked_rows(rows: torch.Tensor, mask: torch.Tensor, cap: int):
    """Order-stable compaction of (..., T, P, 2) masked rows: the masked
    entries of each chunk in (frame, slot) order, first ``cap`` kept, and
    the exact (..., T) per-frame counts."""
    t, p = mask.shape[-2:]
    n = t * p
    cap = min(cap, n)
    flat_m = mask.reshape(mask.shape[:-2] + (n,))
    idx = torch.arange(n, device=mask.device)
    key = torch.where(flat_m, idx, n)
    order = torch.argsort(key, dim=-1, stable=True)[..., :cap]
    flat_r = rows.reshape(rows.shape[:-3] + (n, 2))
    comp = flat_r.gather(-2, order[..., None].expand(order.shape + (2,)))
    return comp, mask.sum(dim=-1)


def _compact_chunk_outputs(outs: FrameOutputs,
                           cap_per_frame: int) -> CompactChunkOutputs:
    """(B, T, ...) FrameOutputs -> CompactChunkOutputs with a
    T * cap_per_frame row budget."""
    t = outs.show_mask.shape[-1]
    cap = cap_per_frame * t
    upd_rows, upd_counts = _compact_masked_rows(outs.update_rows,
                                                outs.update_mask, cap)
    cp_rows, cp_counts = _compact_masked_rows(outs.cp_xy, outs.cp_mask, cap)
    lead = outs.pts.shape[:-3]
    dev = outs.pts.device
    empty_rows = torch.zeros(outs.update_rows.shape[:-2] + (0, 2),
                             dtype=torch.float32, device=dev)
    empty_mask = torch.zeros(outs.update_mask.shape[:-1] + (0,),
                             dtype=torch.bool, device=dev)
    rest = outs._replace(
        update_rows=empty_rows, update_mask=empty_mask,
        cp_xy=empty_rows, cp_mask=empty_mask,
        pts=torch.zeros(lead + (0, 0, 2), dtype=torch.float32, device=dev),
        pts_valid=torch.zeros(lead + (0, 0), dtype=torch.bool, device=dev),
        motion_labels=torch.zeros(outs.motion_labels.shape[:-1] + (0,),
                                  dtype=torch.int32, device=dev),
    )
    return CompactChunkOutputs(upd_rows=upd_rows, upd_counts=upd_counts,
                               cp_rows=cp_rows, cp_counts=cp_counts,
                               rest=rest)


def _stack_frames(frames: List[FrameOutputs]) -> FrameOutputs:
    """Per-frame (B, ...) outputs -> (B, T, ...)."""
    return FrameOutputs(*(torch.stack(x, dim=1) for x in zip(*frames)))


@functools.lru_cache(maxsize=16)
def make_batched_chunk_runner(cfg: PipelineConfig,
                              frame_size: Tuple[int, int], device="cuda"):
    """(run_chunk_b, init_fn, masks) for one geometry on ``device``.

    run_chunk_b(states, frames (B, T, H, W)) -> (states, outputs (B, T, ...)
    or their compaction with ``cfg.out_cap``): the tracker fold is seeded
    from ``states.prev_gray`` and carried frame to frame.
    init_fn(first_gray (B, H, W)) -> states with the first detection."""
    width, height = frame_size
    roi_mask, sub_masks = build_roi_masks(width, height, cfg.roi)
    _, detect, step_batched = make_step(cfg, frame_size, roi_mask, sub_masks,
                                        device=device)
    row_band = tracker_row_band(cfg, height, sub_masks)

    def run_chunk_b(states: PipelineState, frames: torch.Tensor):
        with record_function("tracker.fold"):
            carry = (states, fold_tracking_levels(states.prev_gray, cfg.lk,
                                                  row_band=row_band))
        outs = []
        for t in range(frames.shape[1]):
            carry, o = step_batched(carry, frames[:, t])
            outs.append(o)
        outs = _stack_frames(outs)
        if cfg.out_cap > 0:
            with record_function("serve.compact"):
                outs = _compact_chunk_outputs(outs, cfg.out_cap)
        return carry[0], outs

    def init_fn(first_gray: torch.Tensor) -> PipelineState:
        st = init_pipeline_state(first_gray, cfg)
        pts, valid = detect(first_gray.to(torch.float32))
        return st._replace(pts=pts, valid=valid)

    return run_chunk_b, init_fn, (roi_mask, sub_masks)


def _to_numpy(tree):
    """A NamedTuple of tensors (nested) -> the same of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return type(tree)(*(_to_numpy(x) for x in tree))


def _index(tree, b: int):
    if isinstance(tree, np.ndarray):
        return tree[b]
    return type(tree)(*(_index(x, b) for x in tree))


class StreamSink:
    """Per-stream host sinks of the batched pipeline: ``lk_tpu``'s
    ``VideoPipeline`` bookkeeping and ``_drain``.

    ``csv_rows`` reproduces vps_<video>.csv (a row per VP update and per
    shown frame, LK_Final.py:612-614,637-638), ``segments`` the accepted
    flow lines, ``cross_points`` the accepted CPs, ``vp_per_frame`` the
    shown VP or None per frame."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.csv_rows: List[Tuple[float, float]] = []
        self.segments: List[dict] = []
        self.cross_points: List[Tuple[float, float]] = []
        self.motion_rows: List[Tuple[float, ...]] = []
        self.vp_per_frame: List[Optional[Tuple[float, float]]] = []
        self.frames_done = 0

    def _drain(self, outs, n_valid: Optional[int] = None) -> None:
        """Append one stream's chunk outputs (numpy, (T, ...)); only the
        first ``n_valid`` frames belong to the stream."""
        compact = isinstance(outs, CompactChunkOutputs)
        if compact:
            comp, outs = outs, outs.rest
        t = outs.show_mask.shape[0]
        nv = t if n_valid is None else max(0, min(int(n_valid), t))
        if nv == 0:
            return
        show_rows = np.asarray(outs.show_row, np.float64)[:nv]
        show_mask = np.asarray(outs.show_mask)[:nv]
        seg_s = np.asarray(outs.line_start)[:nv]
        seg_e = np.asarray(outs.line_stop)[:nv]
        seg_m = np.asarray(outs.line_mask)[:nv]
        fracs = np.asarray(outs.motion_fracs)[:nv]
        if compact:
            cap = comp.upd_rows.shape[-2]
            upd_counts = np.asarray(comp.upd_counts, np.int64)[:nv]
            cp_counts = np.asarray(comp.cp_counts, np.int64)[:nv]
            n_upd = int(upd_counts.sum())
            n_cp = int(cp_counts.sum())
            if n_upd > cap or n_cp > cap:
                raise RuntimeError(
                    f"output compaction overflow: chunk emitted "
                    f"{max(n_upd, n_cp)} rows > budget {cap}; raise "
                    f"PipelineConfig.out_cap (or set 0 to disable)")
            upd_rows = np.asarray(comp.upd_rows, np.float64)[:n_upd]
            cp_rows = np.asarray(comp.cp_rows, np.float64)[:n_cp]
            upd_frame = np.repeat(np.arange(nv), upd_counts)
        else:
            upd_m = np.asarray(outs.update_mask)[:nv]
            cp_m = np.asarray(outs.cp_mask)[:nv]
            upd_rows = np.asarray(outs.update_rows, np.float64)[:nv][upd_m]
            cp_rows = np.asarray(outs.cp_xy, np.float64)[:nv][cp_m]
            upd_frame = np.nonzero(upd_m)[0]

        self.motion_rows.extend(map(tuple, np.round(fracs, 4)))
        self.cross_points.extend(map(tuple, cp_rows))
        # per frame, its update rows in order, then its show row
        if self.cfg.csv_rows_on_update:
            show_frame = np.nonzero(show_mask)[0]
            allr = np.concatenate([upd_rows, show_rows[show_mask]], axis=0)
            key = np.concatenate([upd_frame * 2, show_frame * 2 + 1])
            self.csv_rows.extend(
                map(tuple, allr[np.argsort(key, kind="stable")]))
        else:
            self.csv_rows.extend(map(tuple, show_rows[show_mask]))
        self.vp_per_frame.extend(
            tuple(r) if m else None for r, m in zip(show_rows, show_mask))
        self.segments.extend(
            dict(start=a.copy(), stop=b.copy())
            for a, b in zip(seg_s[seg_m], seg_e[seg_m]))
        self.frames_done += nv


class MultiStreamPipeline:
    """B same-geometry streams batched through one pipeline step on
    ``device`` (the card unless the caller names another device).

    Feed processed float32 frames (``feed_processed``) or a time-major
    (F, B, H, W) u8 staging tensor on the device (``feed_staged``, the
    serving hot path).  The first feed consumes one frame per stream for
    the initial detection.  Per-stream host bookkeeping goes to the B
    ``StreamSink``s in ``pipes``."""

    def __init__(self, cfg: PipelineConfig, src_size: Tuple[int, int],
                 n_streams: int, chunk: int = 16, device="cuda"):
        self.cfg = cfg
        self.n_streams = n_streams
        self.chunk = chunk
        self.src_size = src_size
        self.device = torch.device(device)
        src_w, src_h = src_size
        self.width = cfg.width
        self.height = cfg.derived_height(src_h, src_w)
        self.pipes = [StreamSink(cfg) for _ in range(n_streams)]
        self._run, self._init, self.masks = make_batched_chunk_runner(
            cfg, (self.width, self.height), self.device)
        self._finish = _cached_finish(cfg)
        self.states: Optional[PipelineState] = None
        # pending entries: (chunk outputs, per-slot n_valid | None, sinks)
        self._pending: List[tuple] = []
        self.drain_every = 16
        self.active = np.ones(n_streams, dtype=bool)
        self.retired: List[StreamSink] = []

    def finish_stream(self, b: int) -> None:
        """Mark slot ``b`` ended: later chunks drop its outputs."""
        self.active[b] = False

    def assign_stream(self, b: int, first_gray: torch.Tensor) -> StreamSink:
        """Recycle slot ``b`` for a new stream whose first processed gray
        frame (H, W) is consumed for its initial detection; the old sink
        moves to ``retired``.  Returns the fresh sink."""
        if self.states is None:
            raise RuntimeError("assign_stream before the first feed")
        self.retired.append(self.pipes[b])
        sink = StreamSink(self.cfg)
        self.pipes[b] = sink
        fresh = self._init(torch.as_tensor(first_gray, dtype=torch.float32,
                                           device=self.device)[None])
        self.states = _swap_slot(self.states, fresh, b)
        self.active[b] = True
        return sink

    def _chunk_valid(self, t: int, n_valid) -> Optional[np.ndarray]:
        if n_valid is not None:
            nv = np.asarray(n_valid, np.int64).copy()
            if nv.shape != (self.n_streams,):
                raise ValueError(f"n_valid {nv.shape}, expected "
                                 f"({self.n_streams},)")
            return nv
        if self.active.all():
            return None
        return np.where(self.active, t, 0).astype(np.int64)

    def _run_chunk(self, grays: torch.Tensor, n_valid) -> None:
        self.states, outs = self._run(self.states, grays)
        self._pending.append((outs, self._chunk_valid(grays.shape[1],
                                                      n_valid),
                              list(self.pipes)))
        if len(self._pending) >= self.drain_every:
            self.drain()

    def feed_processed(self, grays: torch.Tensor, n_valid=None) -> None:
        """grays: (B, T, H, W) processed float32 frames on the device."""
        if grays.shape[0] != self.n_streams:
            raise ValueError(f"{grays.shape[0]} streams fed to a "
                             f"{self.n_streams}-stream pipeline")
        if self.states is None:
            self.states = self._init(grays[:, 0].to(torch.float32))
            grays = grays[:, 1:]
            if grays.shape[1] == 0:
                return
        self._run_chunk(grays, n_valid)

    def feed_staged(self, staging_fb: torch.Tensor, t: int, n: int,
                    n_valid=None) -> None:
        """Process frames [t, t+n) of a time-major (F, B, H, W) u8 staging
        tensor: slice, finish (one kernel launch for all n * B frames) and
        the chunk.  Staging at source resolution is first resized
        (INTER_AREA) to the processing size."""
        if staging_fb.shape[1] != self.n_streams:
            raise ValueError(f"staging holds {staging_fb.shape[1]} streams, "
                             f"the pipeline {self.n_streams}")
        src_hw = tuple(int(d) for d in staging_fb.shape[2:])
        resize = src_hw != (self.height, self.width)

        def prep(x):                       # (..., hs, ws) -> f32 (..., h, w)
            with record_function("serve.finish"):
                if resize:
                    x = resize_area(x, self.height, self.width)
                return self._finish(x)

        if self.states is None:
            self.states = self._init(prep(staging_fb[t]))
            t += 1
            n -= 1
            if n == 0:
                return
        c = staging_fb[t:t + n]
        b = c.shape[1]
        g = prep(c.reshape((n * b,) + c.shape[2:]))
        g = g.reshape(n, b, self.height, self.width).transpose(0, 1)
        self._run_chunk(g, n_valid)

    def drain(self) -> None:
        """Fetch every pending chunk's outputs and run the per-stream
        bookkeeping."""
        pending, self._pending = self._pending, []
        with record_function("serve.drain"):
            for outs, nv, pipes in pending:
                host = _to_numpy(outs)
                for b, p in enumerate(pipes):
                    p._drain(_index(host, b),
                             n_valid=None if nv is None else int(nv[b]))

    @property
    def frames_done(self) -> int:
        return sum(p.frames_done for p in self.pipes) + sum(
            p.frames_done for p in self.retired)


def _swap_slot(states, fresh, b: int):
    """states with batch slot b replaced by the single-stream ``fresh``."""
    if isinstance(states, torch.Tensor):
        out = states.clone()
        out[b] = fresh[0]
        return out
    return type(states)(*(_swap_slot(s, f, b) for s, f in zip(states, fresh)))
