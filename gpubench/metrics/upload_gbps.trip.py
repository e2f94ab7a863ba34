"""The BGR upload's rate over the traced single-stream window: the bytes
of every BGR frame the window fed (the frames at the source size, 3 bytes
a pixel) over the device time of the host-to-device copies, GB/s.  The
copies of the resize's weight matrices, one pair a chunk, are among
them.  None for a window without single-stream chunks or without such a
copy."""

from gpubench.metrics._trip import UPLOAD, single_stream


def read(ctx):
    seconds, n = ctx.trace.kernel_seconds(UPLOAD)
    if not single_stream(ctx) or not n:
        return None
    return ctx.units["bgr_bytes"] / seconds * 1e-9
