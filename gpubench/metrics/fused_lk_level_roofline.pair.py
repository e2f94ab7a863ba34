"""The fused LK level kernel's share of its roofline over the traced
requests: the least time of every level of every pair (metrics/_work.py)
over the device time of the kernels named below, %."""

from gpubench.metrics import _work
from gpubench.metrics._readers import roofline_pct

PATTERNS = ("fused_lk_level_kernel",)


def read(ctx):
    least = _work.dense_levels_s(ctx.config) * ctx.units["pairs"]
    return roofline_pct(ctx, PATTERNS, least)
