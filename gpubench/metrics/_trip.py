"""What the single-stream (trip) readers share: every trip metric reads a
window of single-stream chunks, the ``video.chunk`` spans the program opens
around each chunk's step (``VideoPipeline.feed_gray``).  A window that
holds none (a program without that span) reads None for every trip
metric, so the harness leaves them out of the line; no reader reads 0 for
what it did not find."""

from __future__ import annotations

CHUNK = "video.chunk"
WAIT = "video.wait"
UPLOAD = ("Memcpy HtoD",)


def single_stream(ctx) -> bool:
    """Whether the traced window holds a single-stream chunk's span."""
    tr = ctx.trace
    return any(tr.t0 <= s < tr.t1 for s, _ in tr.ranges.get(CHUNK, ()))
