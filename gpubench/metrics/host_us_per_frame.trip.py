"""Host time of the single-stream step per tracked frame over the traced
clip: the ``video.chunk`` spans' total length (a chunk's frames stepped:
on the card the carry's copy-in, a frame graph's replay and the outputs'
clones a frame, the outputs' stacking) over the frames they tracked,
us/frame."""

from gpubench.metrics._spans import host_us_per
from gpubench.metrics._trip import CHUNK


def read(ctx):
    return host_us_per(ctx, CHUNK, "frames")
