"""Share of the traced video window in which the device was idle while
the driver worked a chunk of K pairs (the ``dense.chunk`` span: the
chunk's pyramid build and its levels' checks, allocations and launches),
%.  The rest of the video's idle time lies in the leftover pairs'
per-frame chain, the output copy and the harness."""

from gpubench.metrics._spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "dense.chunk")
