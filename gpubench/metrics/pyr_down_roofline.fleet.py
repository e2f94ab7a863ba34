"""The pyramid kernel's share of its roofline over the traced serving
window: the least time of every tracker pyramid of the stream batch
(metrics/_fleet.py) over the device time of the kernels named below, %."""

from gpubench.metrics import _fleet

PATTERNS = ("pyramid_kernel",)


def read(ctx):
    return _fleet.roofline(ctx, PATTERNS, _fleet.pyramid_s(ctx))
