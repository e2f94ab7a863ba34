"""Asynchronous ingest, a decode/preprocess producer overlapped with the
pipeline: counterpart of ``lk_tpu.io.prefetch`` (numpy and threads only).

The reference decodes synchronously inside its frame loop (``cap.read()``
at LK_Final.py:509-517).  Here a producer thread drains the source
iterator (any codec ``cv2.VideoCapture`` opens, or a synthetic generator),
groups frames into fixed-size chunks, applies the transform
(``VideoPipeline._ingest``: the upload and the preprocess; on the card
``VideoPipeline._ingest_on`` queues them on a stream of the producer's own
and returns an event the consumer's stream waits for) and parks finished
chunks in a bounded queue.  The consumer blocks only when the producer
cannot keep up.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

_SENTINEL = object()


def _queue_put(q, stop, item, force: bool = False):
    """Bounded put that gives up when ``stop`` is set (unless forced, so
    the terminating sentinel always lands)."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            if stop.is_set() and not force:
                return


class ChunkPrefetcher:
    """Iterate ``transform(chunk)`` over fixed-size frame chunks, decoded
    and transformed ``depth`` chunks ahead on a producer thread.

    Parameters
    ----------
    frames:     iterable of single frames (any np-stackable objects).
    chunk:      frames per emitted chunk (the trailing chunk may be short).
    depth:      bounded-queue capacity — how far the producer may run ahead.
    transform:  optional host/device staging fn applied on the producer
                thread (e.g. ``VideoPipeline._ingest``: the upload and the
                preprocess); identity when None.

    Worker exceptions re-raise in the consumer.  ``producer_done_at`` records
    when decoding finished (wall clock) — the overlap evidence used by tests
    and the profiling summary.
    """

    def __init__(
        self,
        frames: Iterable[Any],
        chunk: int,
        depth: int = 4,
        transform: Optional[Callable[[np.ndarray], Any]] = None,
        first_extra: int = 0,
    ):
        """``first_extra``: the FIRST emitted chunk carries this many extra
        frames (pipeline init consumes one frame of the first feed, so
        first_extra=1 keeps every processed chunk the same length)."""
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.producer_done_at: Optional[float] = None
        self.producer_busy_s = 0.0  # decode+transform wall time (producer)

        def _produce():
            try:
                buf = []
                target = chunk + first_extra
                t0 = time.perf_counter()
                for f in frames:
                    buf.append(f)
                    if len(buf) == target:
                        out = np.stack(buf)
                        buf = []
                        target = chunk
                        out = transform(out) if transform else out
                        self.producer_busy_s += time.perf_counter() - t0
                        self._put(out)
                        t0 = time.perf_counter()
                    if self._stop.is_set():
                        return
                if buf:
                    out = np.stack(buf)
                    out = transform(out) if transform else out
                    self.producer_busy_s += time.perf_counter() - t0
                    self._put(out)
            except BaseException as e:  # re-raised by the consumer
                self._err = e
            finally:
                self.producer_done_at = time.perf_counter()
                self._put(_SENTINEL, force=True)

        self._thread = threading.Thread(
            target=_produce, name="lk-tpu-ingest", daemon=True
        )
        self._thread.start()

    def _put(self, item, force: bool = False):
        _queue_put(self._q, self._stop, item, force)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        """Stop the producer early (consumer abandoned the stream)."""
        self._stop.set()
        # drain so a blocked put() wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class MultiStreamPrefetcher:
    """Batched live ingest: B per-stream decode threads + one coordinator.

    Each stream gets its own :class:`ChunkPrefetcher` (decode/preprocess runs
    concurrently across streams — cv2 releases the GIL); a coordinator thread
    zips matching chunks, stacks them into a (B, T, ...) batch, applies
    ``batch_transform`` (typically the upload and the finish, so the upload
    overlaps consumer compute), and parks results in a bounded queue:
    decode, upload and pipeline compute all overlap.

    Streams of unequal length truncate to the shortest (a ragged trailing
    chunk is cut to the minimum length present; serving real mixed-length
    sources would re-batch dying streams upstream).
    """

    def __init__(
        self,
        streams: "list[Iterable[Any]]",
        chunk: int,
        depth: int = 2,
        stream_transform: Optional[Callable[[np.ndarray], Any]] = None,
        batch_transform: Optional[Callable[[np.ndarray], Any]] = None,
        first_extra: int = 0,
    ):
        self._pfs = [
            ChunkPrefetcher(s, chunk, depth=depth,
                            transform=stream_transform,
                            first_extra=first_extra)
            for s in streams
        ]
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.producer_done_at: Optional[float] = None

        def _coordinate():
            try:
                for parts in zip(*self._pfs):
                    n = min(p.shape[0] for p in parts)
                    if n == 0:
                        break
                    batch = np.stack([p[:n] for p in parts])
                    out = (batch_transform(batch) if batch_transform
                           else batch)
                    self._put(out)
                    if self._stop.is_set():
                        return
            except BaseException as e:
                self._err = e
            finally:
                self.producer_done_at = time.perf_counter()
                self._put(_SENTINEL, force=True)

        self._thread = threading.Thread(
            target=_coordinate, name="lk-tpu-ingest-batch", daemon=True
        )
        self._thread.start()

    @property
    def decode_busy_s(self) -> float:
        """Total per-stream decode+transform wall time (overlap evidence)."""
        return sum(p.producer_busy_s for p in self._pfs)

    def _put(self, item, force: bool = False):
        _queue_put(self._q, self._stop, item, force)

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        self._stop.set()
        for p in self._pfs:
            p.close()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
