"""The 95th percentile of the per-pair driver's host time over the traced
requests: the lengths of the ``dense.pair`` spans, us."""

from gpubench.metrics._spans import host_us_p95


def read(ctx):
    return host_us_p95(ctx, "dense.pair")
