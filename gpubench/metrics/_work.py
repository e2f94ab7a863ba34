"""Work counts of the program's kernels, from shapes alone.

A kernel's least time on one NVIDIA H100 SXM is the larger of its f32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s (NVIDIA's data
sheet, at the 700 W power limit), counting each input byte read once and
each output byte written once, whatever kernel does the work.  The
operation counts per pixel were counted on the kernel bodies when the
kernels were written (``chip_smoke.py``); they are frozen here so that a
later change to the program cannot move them.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per output pixel per iteration of the fused LK level
# (Scharr 16, warp 32, residual and products 10, five 15x15 box sums 140,
# gate and solve 38)
LK_OPS_PX = 236
# pyrDown: 6.75 operations per input pixel of each level
PYR_OPS_IN_PX = 6.75
# the window gather: ~40 operations per prev-window pixel
GATHER_OPS_PX = 40


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds, what bounds it) for moving ``nbytes`` and doing
    ``ops`` f32 operations."""
    t_b, t_o = nbytes / HBM_BYTES_S, ops / F32_FLOPS
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def level_bound(k: int, h: int, w: int, n_iters: int, coarse_in: bool,
                write_stats: bool, frames: int | None = None
                ) -> tuple[float, str]:
    """One fused-level call over k pairs of (h, w) levels: each of the
    ``frames`` distinct frames read once (2 k for k separate pairs, k + 1
    for the k pairs of a clip, where frame t is the next of pair t - 1 and
    the prev of pair t), the flow read once (a quarter of it when it
    comes from the coarser level) and written once, min_eig (f32) and
    valid (bool) written once when the level writes its stats."""
    px = k * h * w
    frames = 2 * k if frames is None else frames
    flow_in = px * 2 * 4 // (4 if coarse_in else 1)
    nbytes = (frames * h * w * 4 + flow_in + px * 2 * 4
              + (px * 5 if write_stats else 0))
    return bound_s(nbytes, px * n_iters * LK_OPS_PX)


def pyramid_bound(n: int, hw, pad_hw, levels: int) -> tuple[float, str]:
    """One pyramid build of n f32 frames: the frames read once, the padded
    base (when it differs from the frames) and every level written once."""
    (h, w), (hp, wp) = hw, pad_hw
    nbytes = n * h * w * 4 + (n * hp * wp * 4 if (hp, wp) != (h, w) else 0)
    ops = 0.0
    for _ in range(levels):
        ops += n * hp * wp * PYR_OPS_IN_PX
        hp, wp = (hp + 1) // 2, (wp + 1) // 2
        nbytes += n * hp * wp * 4
    return bound_s(nbytes, ops)


def finish_bound(n: int, h: int, w: int) -> tuple[float, str]:
    """The serving finish of n u8 frames: u8 read once, f32 written once
    (tone and 3x3 blur are a few operations per byte)."""
    return bound_s(n * h * w * (1 + 4), 0.0)


def gather_bound(n: int, win_h: int, win_w: int, sw_h: int,
                 sw_w: int) -> tuple[float, str]:
    """One window gather of n points: the prev window with its Scharr halo
    and the next superwindow read once, the prev/ix/iy windows and the
    superwindow written once."""
    read = n * ((win_h + 3) * (win_w + 3) + sw_h * sw_w) * 4
    written = n * (3 * (win_h + 1) * (win_w + 1) + sw_h * sw_w) * 4
    return bound_s(read + written, n * (win_h + 1) * (win_w + 1) * GATHER_OPS_PX)


def level_sizes(h: int, w: int, levels: int) -> list:
    """(h, w) of each pyramid level, level 0 first (ceil halving)."""
    out = [(h, w)]
    for _ in range(levels - 1):
        h, w = (h + 1) // 2, (w + 1) // 2
        out.append((h, w))
    return out


def dense_levels_s(config: dict, pairs: int = 1,
                   clip: bool = False) -> float:
    """Least seconds of the fused levels of ``pairs`` 1080p pairs: every
    level of the dense config's pyramid at its true size, the top from
    zero flow, the others from the coarser flow, the stats written at
    level 0.  Separate pairs read two frames each; the pairs of one clip
    (``clip``) read each of their pairs + 1 frames once."""
    d = config["dense"]
    n = d["pyramid_levels"]
    sched = d["iter_schedule"]
    total = 0.0
    for lv, (h, w) in enumerate(level_sizes(config["height"],
                                            config["width"], n)):
        iters = sched[min(lv, len(sched) - 1)]
        total += level_bound(pairs, h, w, iters, coarse_in=lv != n - 1,
                             write_stats=lv == 0,
                             frames=pairs + 1 if clip else None)[0]
    return total


def dense_frame_pyramid_s(config: dict) -> float:
    """Least seconds of one frame's pyramid (its levels above the base)."""
    hw = (config["height"], config["width"])
    return pyramid_bound(1, hw, hw, config["dense"]["pyramid_levels"] - 1)[0]
