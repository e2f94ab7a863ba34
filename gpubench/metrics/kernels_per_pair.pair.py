"""Device kernel launches per flow field over the traced requests."""

from gpubench.metrics._readers import kernels_per


def read(ctx):
    return kernels_per(ctx, "pairs")
