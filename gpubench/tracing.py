"""The traced window: a ``torch.profiler`` trace reduced to what the
per-layer readers need.

``Trace.record(run)`` runs ``run`` under the profiler with CPU and CUDA
activities.  The profiler can lose the first kernels of a trace, so a few
short device spins, waited out, open it; the window proper is a CPU range
``bench.window`` that ends after a ``torch.cuda.synchronize()``, and only
device operations that start inside it count.

The reduction keeps, as (start_ns, end_ns) on one clock:
* ``device``: every kernel, memcpy and memset, with its name and kind;
* ``ranges``: every CPU ``record_function`` range, by name (the program's
  and the harness's ``bench.*``), on any thread.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

WINDOW = "bench.window"
LEAD_SPINS = 8
SPIN_CYCLES = 6_000_000          # ~3 ms each at the H100's boost clock
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e) -> str:
    """The event's Kineto activity type; PyTorch versions whose events do
    not say it are told by device and name."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    on_device = str(e.device_type()).endswith("CUDA")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu"
    name = e.name()
    return ("gpu_memcpy" if name.startswith("Memcpy")
            else "gpu_memset" if name.startswith("Memset") else "kernel")


class Trace:
    """The reduced trace of one window (see the module docstring)."""

    def __init__(self, events):
        self.ranges = defaultdict(list)
        device = []
        for e in events:
            kind = _kind(e)
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind == "user_annotation":
                self.ranges[e.name()].append((start, end))
            elif kind in DEVICE_KINDS:
                device.append((start, end, e.name(), kind))
        if not self.ranges.get(WINDOW):
            raise RuntimeError(f"the trace holds no {WINDOW} range")
        self.t0, self.t1 = self.ranges[WINDOW][0]
        self.device = sorted(d for d in device if self.t0 <= d[0] < self.t1)

    @classmethod
    def record(cls, run) -> "Trace":
        """Run ``run()`` in a traced window and reduce its trace."""
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            time.sleep(0.01)
            with record_function(WINDOW):
                run()
                torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = cls(prof.profiler.kineto_results.events())
        trace.reduce_s = time.perf_counter() - t0
        return trace

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        merged = []
        for s, e, _, _ in self.device:
            e = min(e, self.t1)
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        any of ``patterns``."""
        total, n = 0, 0
        for s, e, name, _ in self.device:
            if any(p in name for p in patterns):
                total += e - s
                n += 1
        return total * 1e-9, n

    @property
    def kernel_launches(self) -> int:
        """Kernels (not copies or fills) that started in the window."""
        return sum(kind == "kernel" for _, _, _, kind in self.device)

    def range_seconds(self, names) -> tuple[float, int]:
        """(CPU seconds, count) of the ranges named in ``names`` that lie in
        the window."""
        total, n = 0, 0
        for name in names:
            for s, e in self.ranges.get(name, ()):
                if self.t0 <= s < self.t1:
                    total += e - s
                    n += 1
        return total * 1e-9, n

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the innermost host range that was open at each
        gap's middle (``(none)`` where none was)."""
        ops = defaultdict(int)
        for s, e, name, _ in self.device:
            ops[name[:120]] += e - s
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        spans = sorted((s, e, name) for name, rs in self.ranges.items()
                       if name != WINDOW for s, e in rs)
        gaps = defaultdict(int)
        edge, nxt, active = self.t0, 0, []
        for s, e in self.busy_intervals() + [(self.t1, self.t1)]:
            if s > edge:
                mid = (edge + s) // 2
                while nxt < len(spans) and spans[nxt][0] <= mid:
                    active.append(spans[nxt])
                    nxt += 1
                active = [a for a in active if a[1] > mid]
                # innermost of nested ranges: the one opened last
                best = max(active, default=None)
                gaps[best[2] if best else "(none)"] += s - edge
            edge = max(edge, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v * 1e-9] for n, v in device_ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in idle]}
