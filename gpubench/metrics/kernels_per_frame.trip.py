"""Device kernel launches per tracked frame over the traced single-stream
window: every launch of the clip (the preprocess, the step's tracker,
detection, VP scan and show step, the outputs' clones) over the frames it
tracked, launches/frame.  None without single-stream chunks or without a
kernel."""

from gpubench.metrics._readers import kernels_per
from gpubench.metrics._trip import single_stream


def read(ctx):
    if not single_stream(ctx) or not ctx.trace.kernel_launches:
        return None
    return kernels_per(ctx, "frames")
