"""Share of the traced video window in which no device operation ran, %."""

from gpubench.metrics._readers import device_idle_pct as read  # noqa: F401
