"""Share of the traced request window in which the device was idle while
the per-pair driver's call (the ``dense.pair`` span) was open, %."""

from gpubench.metrics._spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "dense.pair")
