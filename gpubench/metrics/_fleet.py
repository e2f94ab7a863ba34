"""What the VP serving (fleet) readers share: every fleet metric reads a
window of serving chunks, the ``serve.chunk`` spans the program opens
around each chunk's step (``MultiStreamPipeline._run_chunk``).  A window
that holds none (a program without that span) reads None for every fleet
metric, so the harness leaves them out of the line; no reader reads 0 for
what it did not find."""

from __future__ import annotations

from gpubench.metrics import _work
from gpubench.metrics._readers import roofline_pct

CHUNK = "serve.chunk"


def serving(ctx) -> bool:
    """Whether the traced window holds a serving chunk's span."""
    tr = ctx.trace
    return any(tr.t0 <= s < tr.t1 for s, _ in tr.ranges.get(CHUNK, ()))


def roofline(ctx, patterns, least_s: float):
    """``roofline_pct`` of a serving window, None where the window holds
    no serving chunk or none of the kernels."""
    if not serving(ctx) or not ctx.trace.kernel_seconds(patterns)[1]:
        return None
    return roofline_pct(ctx, patterns, least_s)


def frame_hw(ctx) -> tuple:
    return ctx.config["height"], ctx.config["width"]


def finish_s(ctx) -> float:
    """Least seconds of the window's finishes: every staged u8 frame the
    window finished read once, its f32 frame written once."""
    h, w = frame_hw(ctx)
    return _work.finish_bound(ctx.units["finish_frames"], h, w)[0]


def gather_s(ctx) -> float:
    """Least seconds of the window's window gathers: per batched frame step
    and tracker level one gather of every slot of every stream (valid or
    not), the prev window with its Scharr halo and the next superwindow
    (32 x 48, which the ROI row band of the levels never cuts at this
    size)."""
    lk = ctx.config["lk"]
    win_w, win_h = lk["win_size"]
    per = _work.gather_bound(ctx.units["points"], win_h, win_w, 32, 48)[0]
    return ctx.units["frame_steps"] * (lk["max_level"] + 1) * per


def pyramid_s(ctx) -> float:
    """Least seconds of the window's tracker pyramids: each build of the
    stream batch's frames (a chunk's first prev frames, then every
    frame), read once, its ``max_level`` levels written once; the fold
    crops the levels to the ROI row band after the build."""
    h, w = frame_hw(ctx)
    per = _work.pyramid_bound(ctx.units["streams"], (h, w), (h, w),
                              ctx.config["lk"]["max_level"])[0]
    return ctx.units["pyramid_builds"] * per
