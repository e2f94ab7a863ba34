"""The arithmetic the per-layer readers share.  Each reader
``metrics/<name>.py`` is a ``read(ctx)`` returning the metric's value, or
None where its trace holds nothing to read; ``ctx`` is the harness's
``ReaderContext`` (the reduced trace, the window's units of work, the
cell's configuration and traffic)."""

from __future__ import annotations


def device_idle_pct(ctx) -> float:
    """100 (1 - busy / window): busy is the union of the device operations'
    intervals inside the traced window."""
    tr = ctx.trace
    if not tr.device:
        raise LookupError("the traced window holds no device operation")
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(ctx, patterns, least_s: float) -> float:
    """100 least_s / the device time of the kernels whose name holds one
    of ``patterns``.  A share whose kernels are not in the trace fails the
    traced run; it never reads 0."""
    seconds, n = ctx.trace.kernel_seconds(patterns)
    if n == 0:
        raise LookupError(f"no device kernel in the trace matches {patterns}")
    return 100.0 * least_s / seconds


def kernels_per(ctx, unit: str) -> float:
    """Device kernel launches in the window per ``unit`` of work."""
    return ctx.trace.kernel_launches / ctx.units[unit]
