"""Share of the traced single-stream window (one whole clip) in which no
device operation ran, % (None for a window without single-stream
chunks)."""

from gpubench.metrics._readers import device_idle_pct
from gpubench.metrics._trip import single_stream


def read(ctx):
    return device_idle_pct(ctx) if single_stream(ctx) else None
