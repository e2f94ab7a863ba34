"""Host time of the serving step per stream-frame over the traced chunks:
the ``serve.chunk`` spans' total length (the tracker's fold, every frame's
batched step with its one host read, the output compaction) over the
stream-frames they stepped, us/frame."""

from gpubench.metrics._fleet import CHUNK
from gpubench.metrics._spans import host_us_per


def read(ctx):
    return host_us_per(ctx, CHUNK, "stream_frames")
