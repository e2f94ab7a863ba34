"""Tracing / profiling: frame-rate meter, named spans, device profiler
hook: counterpart of ``lk_tpu.utils.profiling``.

The reference's only instrumentation is an FPS counter drawn on each frame
(reference LK_Final.py:655-660).  Here: the same rolling FPS meter for host
loops, ``span``, the profiler range every span of the port opens, named
span timing with summary stats, and a context manager around
``torch.profiler`` for device traces.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records on the calling thread, and otherwise one shared no-op
context: with no profiler, a span site costs one flag check and
dispatches no profiler op.  Ranges opened on one thread nest, so the
enclosing range is the span that caused a nested one.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name`` when a profiler is recording on this
    thread, else a shared no-op context: ``with span("dense.chunk"): ...``."""
    if _profiling():
        return record_function(name)
    return _OFF


class FrameRateMeter:
    """Rolling frames-per-second over the last ``window`` ticks."""

    def __init__(self, window: int = 30):
        self.times = collections.deque(maxlen=window)

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        for _ in range(n):
            self.times.append(now)
        return self.fps

    @property
    def fps(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0


class Spans:
    """Accumulating named wall-clock spans: with spans("track"): ...  Each
    also opens ``span(name)``, so a profiled run shows it on the trace's
    clock."""

    def __init__(self):
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1

    def summary(self) -> str:
        lines = []
        for k in sorted(self.total, key=self.total.get, reverse=True):
            n = self.count[k]
            t = self.total[k]
            lines.append(
                f"{k:24s} {t:8.3f}s  x{n}  {t / n * 1e3:8.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the host, and the card
    when there is one) and write a Chrome trace, ``trace.json``, into
    ``log_dir`` (view it in chrome://tracing or Perfetto).  Yields the
    profiler, whose ``key_averages()`` sums the events by name.

    The trace holds the port's spans as named ranges: on the dense path
    ``dense.pair`` (a ``dense_pyramidal_lk`` call), ``dense.video`` (a
    ``dense_pyramidal_lk_video`` call), ``dense.chunk`` and ``dense.cat``
    (its chunks, the leftover pairs' one, and the output copy); on the VP
    path ``tracker.*``, ``step.*``, ``serve.*`` and ``video.*``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
