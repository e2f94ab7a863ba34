"""Share of the traced single-stream window the feeding thread spent
waiting for the prefetcher's next chunk (the ``video.wait`` spans, around
the wait in ``VideoPipeline.run``): how far the producer's decode, upload
and preprocess set the pace, % (None without such spans)."""

from gpubench.metrics._trip import WAIT


def read(ctx):
    total_s, n = ctx.trace.range_seconds([WAIT])
    if not n:
        return None
    return 100.0 * total_s / ctx.trace.window_s
