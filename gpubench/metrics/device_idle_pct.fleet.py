"""Share of the traced serving window in which no device operation ran, %
(None for a window without serving chunks)."""

from gpubench.metrics._fleet import serving
from gpubench.metrics._readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx) if serving(ctx) else None
