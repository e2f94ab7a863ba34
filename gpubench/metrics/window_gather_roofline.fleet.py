"""The tracker's window-gather kernel's share of its roofline over the
traced window: the least time of every level's gather of every frame step
(metrics/_fleet.py) over the device time of the kernels named below, %."""

from gpubench.metrics import _fleet

PATTERNS = ("window_gather_kernel",)


def read(ctx):
    return _fleet.roofline(ctx, PATTERNS, _fleet.gather_s(ctx))
