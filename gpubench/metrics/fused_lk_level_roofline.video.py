"""The fused LK level kernel's share of its roofline over the traced
video calls: the least time of every level of each clip, each frame of
the clip read once per level (metrics/_work.py), over the device time of
the kernels named below, %."""

from gpubench.metrics import _work
from gpubench.metrics._readers import roofline_pct

PATTERNS = ("fused_lk_level_kernel",)


def read(ctx):
    pairs = ctx.units["pairs"] // ctx.units["calls"]
    least = (_work.dense_levels_s(ctx.config, pairs, clip=True)
             * ctx.units["calls"])
    return roofline_pct(ctx, PATTERNS, least)
