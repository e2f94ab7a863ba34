"""Host time of the video driver per flow field over the traced calls:
the ``dense.video`` spans' total length over the pairs, us/pair."""

from gpubench.metrics._spans import host_us_per


def read(ctx):
    return host_us_per(ctx, "dense.video", "pairs")
