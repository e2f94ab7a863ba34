"""The pyramid kernel's share of its roofline over the traced video
calls: the least time of one pyramid per frame of each clip, each frame
read once and its levels written once (metrics/_work.py), over the device
time of the kernels named below, %."""

from gpubench.metrics import _work
from gpubench.metrics._readers import roofline_pct

PATTERNS = ("pyramid_kernel",)


def read(ctx):
    least = _work.dense_frame_pyramid_s(ctx.config) * ctx.units["frames"]
    return roofline_pct(ctx, PATTERNS, least)
