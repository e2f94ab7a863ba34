"""The serving finish kernel's share of its roofline over the traced
window: the least time of every frame it finished (metrics/_fleet.py) over
the device time of the kernels named below, %."""

from gpubench.metrics import _fleet

PATTERNS = ("finish_kernel",)


def read(ctx):
    return _fleet.roofline(ctx, PATTERNS, _fleet.finish_s(ctx))
