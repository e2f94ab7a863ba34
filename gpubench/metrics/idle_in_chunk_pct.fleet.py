"""Share of the traced serving window in which the device was idle while a
chunk's step (the ``serve.chunk`` span) ran on the host, %.  The rest of
the window's idle time lies in the finish's launch, the drains, the
recycling of slots and the harness."""

from gpubench.metrics._fleet import CHUNK
from gpubench.metrics._spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, CHUNK)
