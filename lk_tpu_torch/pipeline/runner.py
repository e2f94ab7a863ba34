"""The VP pipeline's runners and host loops: counterpart of
``lk_tpu.pipeline.runner`` (``_cached_runner``, ``_cached_preprocess``,
``_cached_finish``, ``_compact_masked_rows``, ``_compact_chunk_outputs``,
``make_chunk_runner``, ``make_batched_chunk_runner``, ``VideoPipeline``
and ``MultiStreamPipeline``).  ``_cached_runner`` is ``make_chunk_runner``
itself, cached.

A chunk is a Python loop over its T frames (``lk_tpu``'s ``lax.scan``):
one stream per step in ``make_chunk_runner``, the whole stream batch in
each step in ``make_batched_chunk_runner``.  The JAX package's ``jit``
caches become ``functools.lru_cache``'d constructors of masks and steps,
keyed by the frozen configs, the geometry and the device.  On the card the
tracker's pyramid, the finish and the batched tracker's gather are the
CUDA kernels of ``ops/blur.py``, ``ops/finish.py`` and ``flow/sparse.py``;
with tensors on the CPU, their plain versions.

On the card a chunk replays one CUDA graph of its step per frame
(``_FramePrograms``): ``chunk_graph_counts`` counts the batched runner's
captures, replayed chunks and op-by-op chunks, ``video_graph_counts`` the
single-stream runner's.  ``MultiStreamPipeline`` copies each chunk's
outputs into pinned host buffers as the chunk ends and books them into the
sinks in slices between the next chunk's frames, while the card steps
them: ``drain_counts`` counts where stream-chunks were booked and the
spills read.

``VideoPipeline`` is the reference's ``Run()`` (LK_Final.py:508-705) for
one video: frames in, ``csv_rows`` (vps_<video>.csv) and the other sinks
out, with checkpoints and a prefetching producer thread, which on the card
uploads and preprocesses on a stream of its own.
``MultiStreamPipeline`` batches B same-geometry streams through one step
and drains each stream's outputs into its own ``VideoPipeline``; with a
``mesh`` (``torch.distributed``, one process per device) each rank holds
the staging, states and sinks of its B/D streams and runs the ordinary
single-device serving step on them, with no collective.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.flow.sparse import fold_tracking_levels
from lk_tpu_torch.ops import finish as _finish_ops
from lk_tpu_torch.ops.rasterize import build_roi_masks
from lk_tpu_torch.ops.resize import resize_area
from lk_tpu_torch.pipeline.state import (CompactChunkOutputs, FrameOutputs,
                                         PipelineState, RowSpill,
                                         init_pipeline_state,
                                         without_stream_axis)
from lk_tpu_torch.pipeline.step import (make_step, preprocess_frame,
                                        tracker_row_band)
from lk_tpu_torch.utils.profiling import span


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
    T * cap_per_frame row budget, the uncompacted rows kept as its spill."""
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
    spill = RowSpill(outs.update_rows, outs.update_mask, outs.cp_xy,
                     outs.cp_mask)
    return CompactChunkOutputs(upd_rows=upd_rows, upd_counts=upd_counts,
                               cp_rows=cp_rows, cp_counts=cp_counts,
                               rest=rest, spill=spill)


def _stack_frames(frames: List[FrameOutputs], dim: int) -> FrameOutputs:
    """Per-frame outputs stacked along a new frame axis ``dim``: 0 for one
    stream's (T, ...), 1 for a batch's (B, T, ...)."""
    return FrameOutputs(*(torch.stack(x, dim=dim) for x in zip(*frames)))


@functools.lru_cache(maxsize=32)
def make_chunk_runner(cfg: PipelineConfig, frame_size: Tuple[int, int],
                      device="cuda"):
    """(run_chunk, init_fn, masks) of one stream for one geometry on
    ``device``; cached, so N same-shape streams share one runner and one
    mask set.

    run_chunk(state, frames (T, H, W), frame_hook=None) -> (state, outputs
    stacked on T, or their compaction with ``cfg.out_cap``):
    ``frame_hook(t, state, outputs)``, when given, sees each frame's new
    state and outputs as the chunk steps them, op by op.  On the card a
    chunk with no ``frame_hook`` replays one CUDA graph of ``step`` per
    frame, as ``make_batched_chunk_runner``'s chunks do (the key: the
    state's and a frame's shapes and types, device and stream), so the
    next video of the geometry replays the graph its first chunk captured.
    init_fn(first_gray (H, W)) -> the state with the first-frame detection
    applied (reference LK_Final.py:481-492 detects on the first frame
    before looping)."""
    width, height = frame_size
    roi_mask, sub_masks = build_roi_masks(width, height, cfg.roi)
    step, detect, _ = make_step(cfg, frame_size, roi_mask, sub_masks,
                                device=device)

    def step_carry(carry, gray: torch.Tensor):
        state, o = step(carry[0], gray)
        return (state,), o

    programs = _FramePrograms(step_carry, 0, video_graph_counts)

    def run_chunk(state: PipelineState, frames: torch.Tensor,
                  frame_hook=None):
        state, outs = programs.run((state,), frames, frame_hook)
        outs = _stack_frames(outs, dim=0)
        if cfg.out_cap > 0:
            outs = _compact_chunk_outputs(outs, cfg.out_cap)
        return state, outs

    def init_fn(first_gray: torch.Tensor) -> PipelineState:
        grays = first_gray.to(torch.float32)[None]
        pts, valid = detect(grays)
        return without_stream_axis(init_pipeline_state(grays, cfg)._replace(
            pts=pts, valid=valid))

    return run_chunk, init_fn, (roi_mask, sub_masks)


@functools.lru_cache(maxsize=32)
def _cached_preprocess(cfg: PipelineConfig, frame_size: Tuple[int, int],
                       device: torch.device):
    """(..., Hs, Ws, 3) u8 BGR numpy -> (..., H, W) f32 processed frames on
    ``device`` (``preprocess_frame``)."""
    width, height = frame_size

    def pre(frames_u8: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(device)
        return preprocess_frame(x, cfg, height, width)

    return pre


# Keys whose frame graph a batched runner keeps; the least recently used
# goes first, and its memory pool with it.  0: every chunk op by op (as a
# caller that rebinds a kernel's module name needs: a graph replays what
# it captured).
CHUNK_GRAPHS = 4

# Batched chunks by how they ran: ``captures`` (a key's frame graph
# captured), ``replays`` (a chunk's frames replayed through the graph) and
# ``eager`` (op by op: a key's first chunk, every chunk with a
# ``frame_hook`` and every chunk off the card).
chunk_graph_counts = {"captures": 0, "replays": 0, "eager": 0}

# Single-stream chunks (``make_chunk_runner``) by how they ran, counted as
# ``chunk_graph_counts`` counts the batched ones.
video_graph_counts = {"captures": 0, "replays": 0, "eager": 0}

# Stream-chunks booked into their sinks by ``MultiStreamPipeline``:
# ``booked_between`` in slices between a later chunk's frames,
# ``booked_at_drain`` by ``drain()``, at the ``drain_every`` bound or on the
# async-drain worker; ``spill_reads``: stream-chunks read from their spill
# on the device (rows over ``out_cap``), by any drain.
drain_counts = {"booked_between": 0, "booked_at_drain": 0, "spill_reads": 0}

_capture_lock = threading.Lock()     # one capture at a time in the process


def reset_counters() -> None:
    for counts in (chunk_graph_counts, video_graph_counts, drain_counts):
        for k in counts:
            counts[k] = 0


def _leaves(tree) -> list:
    """The tensors of a nested NamedTuple, in order (None leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def _rebuild(like, leaves):
    """``like`` (tuples and NamedTuples of tensors) with its tensors
    replaced, in order, from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    items = [_rebuild(x, leaves) for x in like]
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _cloned(tree):
    """A contiguous copy of every tensor of ``tree``."""
    return _rebuild(tree, iter(
        [t.clone(memory_format=torch.contiguous_format)
         for t in _leaves(tree)]))


class _FrameProgram:
    """One key's frame graph: a step from a static carry (a tuple whose
    first item is the states: the batched runner's states and tracker fold,
    the single-stream runner's state alone) and frame, which writes its new
    carry back into the static one and its outputs into its own memory.
    ``frame_axis``: the frames' axis in a chunk; ``counts``: the runner's
    counters."""

    def __init__(self, counts: dict, frame_axis: int):
        self.lock = threading.Lock()     # copy-in to clone-out
        self.counts = counts
        self.frame_axis = frame_axis
        self.graph = None
        self.carry = self.gray = self.outs = None

    def capture(self, step, carry, gray) -> None:
        """Capture the step on a side stream from static tensors shaped as
        ``carry`` and ``gray`` (their contents are not read).  As for the
        dense pair graph, ``torch.cuda.graph``'s synchronize, garbage
        collection and ``empty_cache`` are left out."""
        self.carry = _rebuild(carry, iter(
            [torch.empty_like(t, memory_format=torch.contiguous_format)
             for t in _leaves(carry)]))
        self.gray = torch.empty_like(gray,
                                     memory_format=torch.contiguous_format)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = self.step_in_place(step)
            finally:
                graph.capture_end()
        self.graph, self.outs = graph, outs
        self.counts["captures"] += 1

    def step_in_place(self, step):
        """The captured work: one step of the static carry and frame
        batch, its new carry written back into the static carry; returns
        the frame's outputs.  A new tensor that shares memory with the
        static carry (passed through, or a view) is copied first, so the
        write-back cannot change an output or a later source."""
        carry, outs = step(self.carry, self.gray)
        held = {t.untyped_storage().data_ptr() for t in _leaves(self.carry)}

        def apart(t):
            return t.clone() if t.untyped_storage().data_ptr() in held else t

        outs = _rebuild(outs, iter([apart(t) for t in _leaves(outs)]))
        for dst, src in zip(_leaves(self.carry),
                            [apart(t) for t in _leaves(carry)]):
            dst.copy_(src)
        return outs

    def run(self, carry, frames: torch.Tensor, between=None):
        """Copy ``carry`` in, replay each frame of ``frames`` and clone its
        outputs out of the graph's memory, then call ``between()`` (host
        work while the card steps the frame); returns the states after the
        last frame and the per-frame outputs, none of them sharing memory
        with a later replay."""
        for dst, src in zip(_leaves(self.carry), _leaves(carry)):
            dst.copy_(src)
        outs = []
        for t in range(frames.shape[self.frame_axis]):
            self.gray.copy_(frames.select(self.frame_axis, t))
            self.graph.replay()
            outs.append(_cloned(self.outs))
            if between is not None:
                between()
        self.counts["replays"] += 1
        return _cloned(self.carry[0]), outs


class _FramePrograms:
    """A runner's chunks: ``step(carry, frame) -> (carry, outputs)`` over
    the frames of a chunk (axis ``frame_axis``), op by op or, on the card,
    through the ``_FrameProgram`` of the chunk's key, the least recently
    used of more than ``CHUNK_GRAPHS`` keys dropped; ``counts`` counts the
    chunks by how they ran."""

    def __init__(self, step, frame_axis: int, counts: dict):
        self.step = step
        self.frame_axis = frame_axis
        self.counts = counts
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.lock = threading.Lock()

    def _step_frames(self, carry, frames: torch.Tensor, frame_hook, between):
        outs = []
        for t in range(frames.shape[self.frame_axis]):
            carry, o = self.step(carry, frames.select(self.frame_axis, t))
            outs.append(o)
            if frame_hook is not None:
                frame_hook(t, carry[0], o)
            if between is not None:
                between()
        return carry[0], outs

    def _program(self, states, frames: torch.Tensor):
        """The key's frame program, None off the graph path."""
        if (not frames.is_cuda or CHUNK_GRAPHS <= 0
                or torch.cuda.is_current_stream_capturing()):
            return None
        frame = frames.select(self.frame_axis, 0)
        key = (tuple((t.shape, t.dtype) for t in _leaves(states)),
               frame.shape, frames.dtype, frames.device.index,
               torch.cuda.current_stream().cuda_stream)
        with self.lock:
            prog = self.graphs.get(key)
            if prog is None:
                prog = self.graphs[key] = _FrameProgram(self.counts,
                                                        self.frame_axis)
                while len(self.graphs) > CHUNK_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
        return prog

    def run(self, carry, frames: torch.Tensor, frame_hook=None,
            between=None):
        """(states after the chunk, per-frame outputs).  The key's first
        chunk runs op by op, so every kernel and cache is built outside a
        capture, and then captures; later chunks replay."""
        prog = (None if frame_hook is not None
                else self._program(carry[0], frames))
        if frames.is_cuda and torch.cuda.is_current_stream_capturing():
            between = None
        if prog is None:
            self.counts["eager"] += 1
            return self._step_frames(carry, frames, frame_hook, between)
        with prog.lock, torch.cuda.device(frames.device):
            if prog.graph is None:
                self.counts["eager"] += 1
                out = self._step_frames(carry, frames, None, None)
                prog.capture(self.step, carry,
                             frames.select(self.frame_axis, 0))
                return out
            return prog.run(carry, frames, between)


@functools.lru_cache(maxsize=16)
def make_batched_chunk_runner(cfg: PipelineConfig,
                              frame_size: Tuple[int, int], device="cuda"):
    """(run_chunk_b, init_fn, masks) for one geometry on ``device``.

    run_chunk_b(states, frames (B, T, H, W), frame_hook=None, between=None)
    -> (states, outputs (B, T, ...) or their compaction with
    ``cfg.out_cap``): the tracker fold is seeded from ``states.prev_gray``
    and carried frame to frame; ``frame_hook(t, states, outputs)``, when
    given, sees each frame's new states and uncompacted outputs (B, ...) as
    the chunk steps (a frame-by-frame replay of a chunk reads them);
    ``between()``, when given, runs on the host after each frame is
    queued, replayed or stepped, except while a capture is under way and
    in the key's first chunk, which captures.  On the card a chunk
    with no ``frame_hook`` and no capture under way steps its frames
    through its key's CUDA graph of one batched step (``_FramePrograms``;
    the key: the states' and a frame batch's shapes and types, device and
    stream): later chunks copy the carry in, replay once a frame and clone
    the outputs out.  The step reads nothing back to the host, so the
    graph replays the op-by-op step's work.
    init_fn(first_gray (B, H, W)) -> states with the first detection."""
    width, height = frame_size
    roi_mask, sub_masks = build_roi_masks(width, height, cfg.roi)
    _, detect, step_batched = make_step(cfg, frame_size, roi_mask, sub_masks,
                                        device=device)
    row_band = tracker_row_band(cfg, height, sub_masks)
    programs = _FramePrograms(step_batched, 1, chunk_graph_counts)

    def fold(states: PipelineState):
        with span("tracker.fold"):
            return (states, fold_tracking_levels(states.prev_gray, cfg.lk,
                                                 row_band=row_band))

    def run_chunk_b(states: PipelineState, frames: torch.Tensor,
                    frame_hook=None, between=None):
        states, outs = programs.run(fold(states), frames, frame_hook,
                                    between)
        outs = _stack_frames(outs, dim=1)
        if cfg.out_cap > 0:
            with span("serve.compact"):
                outs = _compact_chunk_outputs(outs, cfg.out_cap)
        return states, outs

    def init_fn(first_gray: torch.Tensor) -> PipelineState:
        st = init_pipeline_state(first_gray, cfg)
        pts, valid = detect(first_gray.to(torch.float32))
        return st._replace(pts=pts, valid=valid)

    return run_chunk_b, init_fn, (roi_mask, sub_masks)


def _to_numpy(tree):
    """A NamedTuple of tensors (nested) -> the same of numpy arrays (numpy
    leaves and None pass through)."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if tree is None or isinstance(tree, np.ndarray):
        return tree
    return type(tree)(*(_to_numpy(x) for x in tree))


def _index(tree, b: int):
    if tree is None:
        return None
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return tree[b]
    return type(tree)(*(_index(x, b) for x in tree))


class VideoPipeline:
    """The host loop of one video on ``device`` (the card unless the caller
    names another device): feeds frames, drains the outputs into the
    sinks, the reference's ``Run()``.

    ``csv_rows`` reproduces vps_<video>.csv (a row per VP update and per
    shown frame, LK_Final.py:612-614,637-638,722), ``segments`` the
    accepted flow lines (line_segments.pkl, LK_Final.py:375-377,559),
    ``cross_points`` the accepted CPs, ``vp_per_frame`` the shown VP or
    None per frame, ``motion_rows`` the motion-class fractions."""

    def __init__(self, cfg: PipelineConfig, src_size: Tuple[int, int],
                 chunk: int = 8, host_preprocess: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.src_w, self.src_h = src_size
        self.height = cfg.derived_height(self.src_h, self.src_w)
        self.width = cfg.width
        self.chunk = chunk
        self.device = torch.device(device)
        # host_preprocess: gray + INTER_AREA resize with cv2 on the host
        # (u8-rounded, as the reference), the finish on the device;
        # otherwise the whole preprocess runs on the device
        self.host_preprocess = host_preprocess
        frame_size = (self.width, self.height)
        self._run, self.init_fn, self.masks = make_chunk_runner(
            cfg, frame_size, self.device)
        self._pre = _cached_preprocess(cfg, frame_size, self.device)
        self._finish = _cached_finish(cfg)
        self.state: Optional[PipelineState] = None
        self.csv_rows: List[Tuple[float, float]] = []
        self.segments: List[dict] = []
        self.cross_points: List[Tuple[float, float]] = []
        self.motion_rows: List[Tuple[float, ...]] = []
        self.vp_per_frame: List[Optional[Tuple[float, float]]] = []
        self.frames_done = 0
        # chunks whose rows overflowed the out_cap budget and were drained
        # from the uncompacted spill
        self.spilled_chunks = 0
        # True once the first fed frame was used for initialization (fresh
        # runs); resumed runs process every fed frame
        self.consumed_init_frame = False
        self._pending_resume: Optional[str] = None
        self.last_prefetcher = None       # set by run(prefetch > 0)
        self._pending_outs: list = []
        # chunks buffered before a host readback: each drain synchronizes
        # with the device and stalls feeding on the bookkeeping
        self.drain_every = 16

    def drain(self) -> None:
        """Fetch the buffered chunks' outputs into the host sinks."""
        pending, self._pending_outs = self._pending_outs, []
        with span("video.drain"):
            for outs in pending:
                self._drain(outs)

    def resume_from(self, path: str) -> None:
        """Restore the pipeline state from a checkpoint at the next feed."""
        self._pending_resume = path

    def _ckpt_meta(self) -> str:
        """Identity string tying a checkpoint to this pipeline's config."""
        return f"{self.width}x{self.height}|{self.cfg!r}"

    def save_checkpoint(self, path: str) -> str:
        from lk_tpu_torch.utils.checkpoint import save_state

        if self.state is None:
            raise RuntimeError("no state to checkpoint yet")
        return save_state(self.state, path, meta=self._ckpt_meta())

    def _ingest(self, frames_u8: np.ndarray) -> torch.Tensor:
        """(T, Hs, Ws, 3) u8 BGR -> (T, H, W) f32 processed frames on the
        device."""
        with span("video.ingest"):
            if self.host_preprocess:
                import cv2 as cv

                grays = np.empty((len(frames_u8), self.height, self.width),
                                 np.uint8)
                for k, f in enumerate(frames_u8):
                    g = cv.cvtColor(np.asarray(f), cv.COLOR_BGR2GRAY)
                    grays[k] = cv.resize(g, (self.width, self.height),
                                         interpolation=cv.INTER_AREA)
                return self._finish(torch.from_numpy(grays).to(self.device))
            return self._pre(frames_u8)

    def _ingest_on(self, stream):
        """``_ingest`` for the producer thread on the card: the upload and
        the preprocess queued on ``stream``, which does not synchronise
        with other streams implicitly, then an event the feeding thread's
        stream waits for (``_arrived``)."""

        def ingest(frames_u8: np.ndarray):
            with torch.cuda.stream(stream):
                grays = self._ingest(frames_u8)
                done = torch.cuda.Event()
                done.record(stream)
            return grays, done

        return ingest

    def _arrived(self, grays: torch.Tensor, done) -> torch.Tensor:
        """A chunk ingested on the producer's stream, ordered before the
        feeding thread's work on its current stream; its memory is not
        reused before that work is done."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        grays.record_stream(current)
        return grays

    def feed(self, frames_u8: np.ndarray) -> Optional[FrameOutputs]:
        """Process (T, Hs, Ws, 3) u8 BGR frames; returns the chunk's
        outputs (on the device)."""
        return self.feed_gray(self._ingest(frames_u8))

    def feed_gray(self, grays: torch.Tensor) -> Optional[FrameOutputs]:
        """Process already-ingested (T, H, W) float32 frames on the device
        (the prefetch path runs ``_ingest`` on the producer thread)."""
        if self.state is None:
            if self._pending_resume is not None:
                # the whole state (prev_gray too) comes back: every fed
                # frame is processed, none consumed for initialization
                from lk_tpu_torch.utils.checkpoint import load_state

                template = without_stream_axis(
                    init_pipeline_state(grays[:1], self.cfg))
                self.state = load_state(template, self._pending_resume,
                                        meta=self._ckpt_meta())
                self._pending_resume = None
            else:
                self.state = self.init_fn(grays[0])
                self.consumed_init_frame = True
                grays = grays[1:]
                if grays.shape[0] == 0:
                    return None
        with span("video.chunk"):
            self.state, outs = self._run(self.state, grays)
        self._pending_outs.append(outs)
        if len(self._pending_outs) >= self.drain_every:
            self.drain()
        return outs

    def _drain(self, outs, n_valid: Optional[int] = None) -> None:
        """Append one stream's chunk outputs ((T, ...) tensors or numpy);
        only the first ``n_valid`` frames belong to the stream (ragged
        lifecycles: ``MultiStreamPipeline`` keeps stepping a finished slot
        until it is recycled, and its outputs are dropped here).  Compacted
        outputs whose rows overflow their budget are read from their
        spill, which stays on the device otherwise."""
        compact = isinstance(outs, CompactChunkOutputs)
        spill = None
        if compact:
            spill, outs = outs.spill, outs._replace(spill=None)
        outs = _to_numpy(outs)
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
                if spill is None:
                    raise RuntimeError(
                        f"output compaction overflow: chunk emitted "
                        f"{max(n_upd, n_cp)} rows > budget {cap} and kept "
                        f"no spill; raise PipelineConfig.out_cap (or set 0 "
                        f"to disable)")
                self.spilled_chunks += 1
                drain_counts["spill_reads"] += 1
                compact = False
                outs = outs._replace(**_to_numpy(spill)._asdict())
        if compact:
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

    def run(self, frames: Iterable[np.ndarray], prefetch: int = 0) -> None:
        """Consume an iterable of single (Hs, Ws, 3) u8 frames in chunks.

        ``prefetch > 0`` decodes and ingests ``prefetch`` chunks ahead on a
        producer thread (``io.prefetch.ChunkPrefetcher``), overlapping host
        decode with the device: the replacement for the reference's
        synchronous ``cap.read()`` loop (LK_Final.py:509-517).  On the card
        the producer uploads and preprocesses on a stream of its own
        (``_ingest_on``), so its work never joins a frame graph that the
        feeding thread captures meanwhile; span ``video.wait`` is the
        feeding thread's wait for the next chunk."""
        if prefetch > 0:
            from lk_tpu_torch.io.prefetch import ChunkPrefetcher

            cuda = self.device.type == "cuda"
            ingest = (self._ingest_on(torch.cuda.Stream(self.device)) if cuda
                      else self._ingest)
            pf = ChunkPrefetcher(frames, self.chunk, depth=prefetch,
                                 transform=ingest)
            self.last_prefetcher = pf
            chunks = iter(pf)
            try:
                while True:
                    with span("video.wait"):
                        item = next(chunks, None)
                    if item is None:
                        break
                    self.feed_gray(self._arrived(*item) if cuda else item)
            finally:
                pf.close()
            self.drain()
            return
        buf: List[np.ndarray] = []
        for f in frames:
            buf.append(f)
            if len(buf) == self.chunk + (1 if self.state is None else 0):
                self.feed(np.stack(buf))
                buf.clear()
        if buf:
            self.feed(np.stack(buf))
        self.drain()


def _layout(leaves) -> tuple:
    return tuple((t.shape, t.dtype) for t in leaves)


class _HostCopy:
    """Pinned host buffers shaped as one chunk's output leaves, numpy views
    of them, and the event recorded after the copy into them was queued."""

    def __init__(self, leaves):
        self.key = _layout(leaves)
        self.tensors = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in leaves]
        self.arrays = [t.numpy() for t in self.tensors]
        self.event = torch.cuda.Event()


class _Pending:
    """A chunk whose rows are not all in its sinks yet: its outputs on the
    device (held until its last slot is booked, the spill read only where a
    slot overflows), their host arrays (``copy``'s views; off the card the
    outputs' own), the per-slot n_valid or None, the sinks that owned its
    slots when it ran, and the next slot to book."""

    __slots__ = ("outs", "host", "copy", "nv", "pipes", "next")

    def __init__(self, outs, host, copy, nv, pipes):
        self.outs, self.host, self.copy = outs, host, copy
        self.nv, self.pipes, self.next = nv, pipes, 0

    def owed(self) -> int:
        return len(self.pipes) - self.next

    def landed(self, wait: bool) -> bool:
        """Whether the host copy is complete; with ``wait``, wait for it."""
        if self.copy is None:
            return True
        if wait:
            self.copy.event.synchronize()
            return True
        return self.copy.event.query()


class MultiStreamPipeline:
    """B same-geometry streams batched through one pipeline step on
    ``device`` (the card unless the caller names another device).

    Feed raw (B, T, Hs, Ws, 3) u8 BGR frames (``feed``), processed float32
    frames (``feed_processed``) or a time-major (F, B, H, W) u8 staging
    tensor on the device (``feed_staged``, the serving hot path).  The
    first feed consumes one frame per stream for the initial detection.
    Per-stream host bookkeeping goes to the B ``VideoPipeline`` sinks in
    ``pipes`` (all sharing one cached runner and mask set).

    Each chunk's outputs are copied into pinned host buffers (a ring reused
    chunk after chunk) as the chunk ends; between the next chunk's frames,
    while the card steps them, the feeding thread books equal slices of
    the slots earlier chunks still owe their sinks (span ``serve.book``).
    ``drain_every`` bounds the chunks whose rows may be outside the sinks:
    beyond it the oldest are booked at once, waiting for their copies.
    ``drain()`` books all that is pending.

    ``mesh``: a ``DeviceMesh`` (``lk_tpu_torch.parallel``) whose
    ``mesh_axis`` shards the streams.  Each rank then owns the
    ``n_local`` streams ``self.streams`` of the ``n_streams`` (their sinks
    are ``pipes``; its device is ``device``) and steps them as the
    single-device pipeline would: streams never talk to each other, so the
    step has no collective.  Feeds, ``n_valid`` and slot indices are this
    rank's streams only."""

    def __init__(self, cfg: PipelineConfig, src_size: Tuple[int, int],
                 n_streams: int, chunk: int = 16,
                 host_preprocess: bool = True, device="cuda", mesh=None,
                 mesh_axis: str = "streams"):
        self.cfg = cfg
        self.n_streams = n_streams
        self.chunk = chunk
        self.src_size = src_size
        self.host_preprocess = host_preprocess
        self.device = torch.device(device)
        self.n_local = n_streams
        self.streams = slice(0, n_streams)
        if mesh is not None:
            size = mesh.size(mesh.mesh_dim_names.index(mesh_axis))
            if n_streams % size != 0:
                raise ValueError(
                    f"n_streams={n_streams} not divisible by mesh axis "
                    f"{mesh_axis!r} size {size}")
            self.n_local = n_streams // size
            at = mesh.get_local_rank(mesh_axis) * self.n_local
            self.streams = slice(at, at + self.n_local)
        self.pipes = [self._sink() for _ in range(self.n_local)]
        self.width = self.pipes[0].width
        self.height = self.pipes[0].height
        self._run, self._init, self.masks = make_batched_chunk_runner(
            cfg, (self.width, self.height), self.device)
        self._finish = _cached_finish(cfg)
        self.states: Optional[PipelineState] = None
        # the last chunk's outputs on the device, as the drain will read them
        self.last_outputs = None
        # chunks whose rows are not all in their sinks, oldest first
        self._pending: List[_Pending] = []
        # free pinned host copies by their leaves' shapes and types
        self._ring: dict = {}
        self._slices_left = 0           # between() calls left in the chunk
        self.drain_every = 16
        self._drain_worker = None
        self._drain_q = None
        self._drain_err: Optional[BaseException] = None
        # ragged lifecycles: a finished slot keeps being stepped with the
        # padding frames the caller stages, its outputs dropped at the
        # drain by the per-chunk n_valid counts; assign_stream swaps a
        # fresh state into the slot and retires the old sink
        self.active = np.ones(self.n_local, dtype=bool)
        self.retired: List[VideoPipeline] = []

    def _sink(self) -> VideoPipeline:
        return VideoPipeline(self.cfg, src_size=self.src_size,
                             chunk=self.chunk,
                             host_preprocess=self.host_preprocess,
                             device=self.device)

    def finish_stream(self, b: int) -> None:
        """Mark slot ``b`` ended: later chunks drop its outputs (pass
        ``n_valid`` for the chunk it ends in, if that end is not
        chunk-aligned).  Its sink stays readable until ``assign_stream``
        recycles the slot."""
        self.active[b] = False

    def assign_stream(self, b: int, first_gray: torch.Tensor) -> VideoPipeline:
        """Recycle slot ``b`` for a new stream whose first processed gray
        frame (H, W) is consumed for its initial detection; the old sink
        moves to ``retired``.  Returns the fresh sink."""
        if self.states is None:
            raise RuntimeError("assign_stream before the first feed")
        self.retired.append(self.pipes[b])
        p = self._sink()
        p.consumed_init_frame = True
        self.pipes[b] = p
        fresh = p.init_fn(torch.as_tensor(first_gray, dtype=torch.float32,
                                          device=self.device))
        self.states = _swap_slot(self.states, fresh, b)
        self.active[b] = True
        return p

    def _chunk_valid(self, t: int, n_valid) -> Optional[np.ndarray]:
        """Per-slot valid-frame counts of a t-frame chunk: an explicit
        ``n_valid`` wins; else active slots own the whole chunk."""
        if n_valid is not None:
            nv = np.asarray(n_valid, np.int64).copy()
            if nv.shape != (self.n_local,):
                raise ValueError(f"n_valid {nv.shape}, expected "
                                 f"({self.n_local},)")
            return nv
        if self.active.all():
            return None
        return np.where(self.active, t, 0).astype(np.int64)

    def start_async_drains(self) -> None:
        """Move the bookkeeping of periodic drains to a worker thread, which
        books each chunk from its pinned host copy once the copy is
        complete; the feeding thread then books nothing between frames.
        ``drain()`` at the end of the stream flushes the worker's queue and
        waits for it; a worker's error is raised there (or at the next
        periodic drain)."""
        import queue
        import threading

        if self._drain_worker is not None:
            return
        self._drain_q = queue.Queue(maxsize=4)

        def work():
            while True:
                item = self._drain_q.get()
                try:
                    if item is None:
                        return
                    self._drain_now(item)
                except BaseException as e:   # raised at the next drain()
                    self._drain_err = e
                finally:
                    self._drain_q.task_done()

        self._drain_worker = threading.Thread(target=work, name="lk-drain",
                                              daemon=True)
        self._drain_worker.start()

    def _start(self, first: torch.Tensor) -> None:
        """The first feed: init states from the first frames (B, H, W)."""
        self.states = self._init(first)
        for p in self.pipes:
            p.consumed_init_frame = True

    def _run_chunk(self, grays: torch.Tensor, n_valid) -> None:
        nv = self._chunk_valid(grays.shape[1], n_valid)
        between = None if self._drain_q is not None else self._book_slice
        self._slices_left = grays.shape[1]
        with span("serve.chunk"):
            self.states, outs = self._run(self.states, grays, between=between)
            pending = self._readback(outs, nv)
        self.last_outputs = outs
        self._pending.append(pending)
        if self._drain_q is not None:
            if len(self._pending) >= self.drain_every:
                pending, self._pending = self._pending, []
                self._raise_drain_err()    # fail fast, do not fill the queue
                self._drain_q.put(pending)
            return
        self._raise_drain_err()            # a slice's, now the chunk is kept
        over = len(self._pending) - self.drain_every
        if over > 0:
            head, self._pending = self._pending[:over], self._pending[over:]
            self._drain_now(head)

    def _readback(self, outs, nv) -> _Pending:
        """The pending entry of a chunk's outputs: on the card, a
        non-blocking copy of every leaf but the spill into pinned host
        buffers from the ring, queued behind the chunk, and its event.  The
        sinks ride along, so a later assign_stream cannot take this chunk's
        rows from the sink that owned the slot."""
        read = outs._replace(spill=None) if hasattr(outs, "spill") else outs
        leaves = _leaves(read)
        copy = None
        if leaves[0].is_cuda:
            try:
                copy = self._ring[_layout(leaves)].pop()
            except (KeyError, IndexError):
                copy = _HostCopy(leaves)
            for dst, src in zip(copy.tensors, leaves):
                dst.copy_(src, non_blocking=True)
            copy.event.record()
            host = _rebuild(read, iter(copy.arrays))
        else:
            host = _to_numpy(read)
        return _Pending(outs, host, copy, nv, list(self.pipes))

    def feed(self, batch: np.ndarray, n_valid=None) -> None:
        """batch: (B, T, Hs, Ws, 3) u8 BGR frames, one row per stream,
        ingested by each stream's ``VideoPipeline``."""
        grays = torch.stack([p._ingest(batch[b])
                             for b, p in enumerate(self.pipes)])
        self.feed_processed(grays, n_valid=n_valid)

    def feed_processed(self, grays: torch.Tensor, n_valid=None) -> None:
        """grays: (B, T, H, W) processed float32 frames on the device.
        ``n_valid``: optional (B,) counts of this chunk's processed frames
        that belong to each slot's stream (the consumed init frame not
        counted); by default the whole chunk for active slots, 0 for
        finished ones."""
        if grays.shape[0] != self.n_local:
            raise ValueError(f"{grays.shape[0]} streams fed to a "
                             f"{self.n_local}-stream pipeline")
        if self.states is None:
            self._start(grays[:, 0].to(torch.float32))
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
        if staging_fb.shape[1] != self.n_local:
            raise ValueError(f"staging holds {staging_fb.shape[1]} streams, "
                             f"the pipeline {self.n_local}")
        src_hw = tuple(int(d) for d in staging_fb.shape[2:])
        resize = src_hw != (self.height, self.width)

        def prep(x):                       # (..., hs, ws) -> f32 (..., h, w)
            with span("serve.finish"):
                if resize:
                    x = resize_area(x, self.height, self.width)
                return self._finish(x)

        if self.states is None:
            self._start(prep(staging_fb[t]))
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
        """Book every pending chunk's outputs into the per-stream sinks;
        with async drains, hand them to the worker and wait for it."""
        pending, self._pending = self._pending, []
        if self._drain_q is not None:
            self._drain_q.put(pending)
            self._drain_q.join()
            self._raise_drain_err()
            return
        self._drain_now(pending)

    def _raise_drain_err(self) -> None:
        if self._drain_err is not None:
            err, self._drain_err = self._drain_err, None
            raise err

    def _drain_now(self, pending) -> None:
        """Book every slot of ``pending``, waiting for each host copy."""
        with span("serve.drain"):
            for p in pending:
                p.landed(wait=True)
                drain_counts["booked_at_drain"] += self._book(p, p.owed())

    def _book_slice(self) -> None:
        """The feeding thread's work between two frames of a chunk: an equal
        share of the slots earlier chunks still owe their sinks, over the
        frames left, from the oldest chunks whose host copies are complete;
        it waits for none.  An error is kept and raised once the chunk has
        run."""
        left, self._slices_left = self._slices_left, self._slices_left - 1
        owed = sum(p.owed() for p in self._pending)
        if owed == 0 or self._drain_err is not None:
            return
        n = -(-owed // max(left, 1))
        with span("serve.book"):
            try:
                while (n > 0 and self._pending
                       and self._pending[0].landed(wait=False)):
                    p = self._pending[0]
                    k = self._book(p, n)
                    drain_counts["booked_between"] += k
                    n -= k
                    if p.owed() == 0:
                        self._pending.pop(0)
            except Exception as e:  # kept for _run_chunk to raise
                self._drain_err = e

    def _book(self, p: _Pending, n: int) -> int:
        """Book the next ``n`` slots of ``p`` (its host copy complete) into
        their sinks; returns how many.  Once the last slot is booked, the
        copy's buffers go back to the ring."""
        spill = getattr(p.outs, "spill", None)
        stop = min(p.next + n, len(p.pipes))
        start = p.next
        for b in range(start, stop):
            mine = _index(p.host, b)
            if spill is not None:           # read only where it overflows
                mine = mine._replace(spill=_index(spill, b))
            p.pipes[b]._drain(mine,
                              n_valid=None if p.nv is None else int(p.nv[b]))
            p.next = b + 1
        if p.owed() == 0 and p.copy is not None:
            self._ring.setdefault(p.copy.key, []).append(p.copy)
            p.copy = None
        return stop - start

    @property
    def frames_done(self) -> int:
        return sum(p.frames_done for p in self.pipes) + sum(
            p.frames_done for p in self.retired)

    @property
    def spilled_chunks(self) -> int:
        """Stream-chunks drained from their spill (rows over out_cap)."""
        return sum(p.spilled_chunks for p in self.pipes) + sum(
            p.spilled_chunks for p in self.retired)


def _swap_slot(states, fresh, b: int):
    """Batched ``states`` with slot b replaced by the single-stream
    ``fresh``."""
    if isinstance(states, torch.Tensor):
        out = states.clone()
        out[b] = fresh
        return out
    return type(states)(*(_swap_slot(s, f, b) for s, f in zip(states, fresh)))
