"""The arithmetic of the readers of the program's spans: the ranges that
``lk_tpu_torch`` opens through ``utils.profiling.span`` on the dense path
(``dense.*``), as the reduced trace keeps them.  A program that opens none of a reader's spans leaves its metric
out of the result line (the reader returns None); no reader reads 0 for
a span it did not find."""

from __future__ import annotations

import numpy as np


def _overlap(a: list, b: list) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_pct(ctx, name: str):
    """100 x the time in which the device was idle while a ``name`` range
    was open, over the window: the ranges, clipped to the window, less
    their intersection with the device's busy intervals.  The ranges of
    one name are disjoint, since a span never opens inside itself.  None
    where the window holds no such range."""
    tr = ctx.trace
    spans = sorted((max(s, tr.t0), min(e, tr.t1))
                   for s, e in tr.ranges.get(name, ())
                   if s < tr.t1 and e > tr.t0)
    if not spans:
        return None
    idle = (sum(e - s for s, e in spans)
            - _overlap(spans, tr.busy_intervals()))
    return 100.0 * idle * 1e-9 / tr.window_s


def host_us_per(ctx, name: str, unit: str):
    """The ``name`` ranges' total length in microseconds per ``unit`` of
    the window's work; None where the window holds none."""
    total_s, n = ctx.trace.range_seconds([name])
    if not n:
        return None
    return 1e6 * total_s / ctx.units[unit]


def host_us_p95(ctx, name: str):
    """The 95th percentile of the ``name`` ranges' lengths in microseconds
    (numpy's linear percentile, as ``pair_ms_p95``); None where the window
    holds none."""
    tr = ctx.trace
    lengths = [(e - s) * 1e-3 for s, e in tr.ranges.get(name, ())
               if tr.t0 <= s < tr.t1]
    if not lengths:
        return None
    return float(np.percentile(lengths, 95))
