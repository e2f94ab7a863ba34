"""Device kernel launches per stream-frame over the traced serving chunks:
every launch of the window (the finish, the tracker's pyramids and window
gathers, the step's VP scan and refinement, the compaction) over the
stream-frames it stepped, launches/frame.  None without serving chunks
or without a kernel."""

from gpubench.metrics._fleet import serving
from gpubench.metrics._readers import kernels_per


def read(ctx):
    if not serving(ctx) or not ctx.trace.kernel_launches:
        return None
    return kernels_per(ctx, "stream_frames")
