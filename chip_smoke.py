#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lk_tpu_torch) on one NVIDIA GPU.

Drives the port's paths and checks them.  The dense video path: pyramidal
LK over 1080p video with the production config.  The per-pair dense
paths at 1080p: A, ``lk_tpu_torch.entry.entry()``'s program (the
production config per pair, pyramid kernel + fused level); B, the
warp-only / precomputed-A config (local warp at L0-L2, the precomputed
level at the top); B16, B with both bf16 options (bf16 box sums, the
bf16-window local warp); C, the default config's XLA level (plain PyTorch
but for the pyramid kernel); C16, C with bf16 box sums.  The serving path: batched VP serving,
MultiStreamPipeline at 64 streams of 860x483 frames, chunk 16, out_cap 48,
preset final, fed from a u8 staging array on the card, as apps/serve.py
runs it.  The single-stream VP pipeline: VideoPipeline, preset final, a
1080p BGR source processed at 860x483, chunk 16, as apps/_common.py's
run_vp_app runs it.

  0. environment: the card's name and power limit, torch, CUDA, nvcc;
  1. build: compiles every CUDA kernel in csrc/ (one nvcc per source, in
     parallel) and prints each kernel's registers, shared memory, spills;
  2. dense kernel vs plain PyTorch version at the 1080p plan shapes, K=4
     pairs (top level 136x256 with 6 iterations; L2, L1, L0 coarse-in,
     stats at L0), and chunk output vs single-pair output, bit for bit;
     per level the kernel's device time beside its bound and whether it
     equals the plain version bit for bit, and its time with each block
     shape forced (same bits checked); per variant beside the time of
     the kernel's first design;
  3. dense main path: dense_pyramidal_lk_video on two synthetic 34-frame
     1080p scenes (8 chunks of 4 pairs and a 1-pair chunk), with the
     launch counters reset just before and read just after (one pyramid
     launch per chunk: 9); flow, min_eig and valid equal to the same run
     with the plain pyramid; mean EPE vs exact ground truth on bench.py's
     grid must be < 0.1 px;
  4. dense timing with CUDA events: pairs/s (output flow fields per second)
     of the chained video through the kernels and through the plain
     versions;
  5. only with --profile: host enqueue and wall per video, a
     torch.profiler breakdown of its device time by kernel group, and (run
     last of all) the fused kernel at L0 against copies built to measure
     its staging alone and its passes alone;
  6. the pyramid build vs plain at the video's 5-frame chunk (padded to
     1088x2048, 3 levels), path A's pair, the serving tracker's batch and
     an odd stack, every level torch.equal, beside its bound, the
     parent's composition (edge pad + one pyrDown launch per level) and
     the library (F.pad + nn.Conv2d per level), and the chunk's time with
     the grid capped at 1, 2 and 4 blocks per SM; the local warp
     at path B's padded L0-L2 with a zoom flow and outliers beyond +-local,
     torch.equal, each level timed beside its bound and the parent's design
     (WARP_PARENT); its bf16-window instances on the same levels (next
     rounded to bf16 first), torch.equal to their plain version and to the
     f32 instance on the rounded plane, timed beside their bound and the
     f32 instance, with the cast's time;
     the precomputed level at path B's top (136x240, 6 iterations) and
     tiled (576x1024 on 64x512 tiles, 2 iterations), one launch per call,
     torch.equal with every block shape at the resident grid and at one
     block per SM, each timed; per call the
     kernels' own device time (torch.profiler) and the CUDA-event time,
     plain ms, bound, library call;
  7. path A: entry()'s fn on its own inputs, then on both scenes' first
     pair, counters reset just before and read just after each (pyramid 1,
     fused level resident 6 + tiled 3, no plain call), EPE < 0.1 px, and
     the flow equal to the run with the plain pyramid and to the video
     chain's pair 0 bit for bit;
  8. paths B, B16, C and C16 on both scenes' first pair, counted the same
     way (B: pyramid 1, local warp 3, precomputed level 1; B16: the same,
     its 3 local warps the bf16 instances; C and C16: pyramid 1 only);
     B's and B16's flow, min_eig and valid equal to the runs with the
     plain precomputed level and with the plain local warp; the EPE of B,
     B16 and C16 < 0.1 px, C's printed;
  9. per-pair timing with CUDA events: ms per pair of paths A, B, B16, C
     and C16; with --profile also each path's host enqueue and device
     time by kernel group;
 10. serving scenes: 64 synthetic road streams expanding from a planted
     VP per stream (apps/serve.py's), each the package's
     SyntheticRoadStream (seed s) rendered on the card into the 64-frame
     staging array;
 11. serving main path: one pass of MultiStreamPipeline.feed_staged +
     drain, counters reset just before and read just after (the finish
     kernel once per chunk plus once for the init frame; the window gather
     three times, the tracker's pyramid and the VP pair scan once per
     frame stepped from the host, that is every frame of the chunk run op
     by op and the frame graph's capture, the replayed chunks launching
     none; the pyramid once more per chunk; no plain call); every stream
     runs
     63 frames, the mean late-trajectory VP error is < 25 px
     (tests/test_pipeline_e2e.py's bound); the first 4 streams run again
     through the plain versions on the card give the same csv rows;
 12. serving kernels vs plain at serving shapes: the finish on (1024, 483,
     860) u8 with and without the tone curve and on odd shapes (W % 4 !=
     0, 2x2, 70,000 frames, f32, an unaligned base), torch.equal, the
     gather on the three folded levels of the 64-stream batch with the
     tracker's frame-major point set and a shuffled one; the VP pair
     scan on the 64 streams' inputs of the first chunk's 16 steps (P =
     190 pairs), one call a step bit-equal to
     process_frame_pairs_reference; device and CUDA-event ms per launch;
 13. serving timing: aggregate stream-frames/s with CUDA events around
     whole feed_staged + drain passes after the warm-up pass of phase 11;
 14. only with --profile: the serving pass's device and host time by
     stage, and the device's busy share;
 15. single-stream main path: one synthetic 1080p road scene with a
     planted VP, 97 BGR frames (7 chunks of 16 from the prefetcher, the
     first frame seeding), run through VideoPipeline.run(prefetch=2) with
     the counters reset just before and read just after (the tracker's
     pyramid and the pair scan once per frame stepped from the host: the
     first chunk's 15, op by op, and the capture of its frame graph,
     derived from runner.video_graph_counts; the later chunks replay the
     graph; the finish and the window gather never; no plain call);
     the late-trajectory VP error < 25 px;
 16. single-stream timing: ms per tracked frame of whole run calls (CUDA
     events, after phase 15's run), prefetch 0, prefetch 2 and the plain
     pyramid (op by op), each run's csv rows, shown VPs and segments equal
     (np.array_equal) to phase 15's; then a run checkpointed after 3
     chunks and resumed in a fresh VideoPipeline, equal too;
 17. only with --profile: a single-stream run's device and host time by
     stage (video.*, tracker.*, step.*), launches per frame and the
     device's busy share;
 18. the VP apps: ``lk_tpu_torch.apps.{final,vp_detect,classify}.main``
     with --synthetic (the package's 1280x720 stream, rendered on the
     card), 49 frames (the init frame + 3 chunks of 16), --out-dir a
     temporary directory, counted (one pyramid and one pair-scan launch
     per frame stepped from the host, derived as in phase 15: final
     replays phase 15's frame graph and launches none, vp_detect and
     classify capture their own; no other kernel, no plain call); a
     well-formed vps_synthetic.csv, the late-trajectory VP error < 25 px,
     classify's motion csv; rows, shown VPs and segments equal
     (np.array_equal) to the same app run with the plain pyramid (op by
     op); ms per
     tracked frame and frames/s of each counted run (host clock around
     main, synchronized);
 19. the tracker apps: ``masking.compute`` and ``roadlines.compute`` at
     their 960-px width on 33 frames, counted (one pyramid launch per
     tracked frame, 32, no other kernel, no plain call), segments equal
     to the plain-pyramid run, roadlines' Hough result on the card within
     1e-4 rad (theta) and 1e-2 px (rho) of the same call on the CPU;
 20. the serving app: ``serve.run_server`` at its defaults (32 streams,
     64 frames, 1280x720 source staged on the card at 860x483), then with
     --async-drains, each counted over its warm-up and timed passes as
     phase 11 (no plain call), every stream with VP output, the mean VP
     error < 25 px; the async run's rows equal the sync run's, and the first 4
     streams' rows within ROWS_TOL of a 4-stream run through the plain
     versions; the aggregate frames/s of each timed pass.

 25. the functions the port added last (run after phase 9, while the
     video's frames are on the card): gaussian_pyramid (one pyramid
     launch), resize_linear, imutils_width_resize, extract_patch (corners
     in and outside the frame), classify_dense_flow and vanishing_lines on
     card tensors against the same calls on CPU tensors (torch.equal, or
     the stated tolerance where a product or a reduction is summed in
     another order), and the 1080p video with padded_build equal to phase
     4's video bit for bit, timed with utils.Timer.

Phases 18-20 print their wall time.

Prints a {"kernels": [...]} JSON line (each entry's "ms" is the kernel's
own device time per call from torch.profiler, its launches counted in the
trace, "event_ms" the CUDA-event time around the wrapper's calls; the
pyramid's "launches" are the dense video's, the serving kernels' phase
11's, "single_stream_launches" phase 15's), the card line, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the exit code is
then non-zero and no result line is printed.  Without a CUDA device, or run
from a directory without the package, it exits non-zero at once.

    python3 chip_smoke.py [--profile]
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1920
FRAMES = 34               # 33 pairs = 8 chunks of 4 + a 1-pair chunk
K = 4                     # pairs per chunk (DenseLKConfig.video_chunk)
# pyramid builds per video: one per chunk, the leftover pairs' included
VIDEO_PYRAMIDS = -(-(FRAMES - 1) // K)
EPE_LIMIT = 0.1           # px, bench.py's gate (ground-truth term)
# Kernel vs plain version: both f32 with the same operation order (the
# kernel is built without FMA contraction), so they should agree to the
# bit; the bounds leave room for a compiler's reassociation only.
FLOW_TOL = 1e-3           # px
EIG_REL_TOL = 1e-4        # of the level's largest min_eig
FLIP_TOL = 1e-4           # fraction of pixels whose valid flag differs
SOURCE = "lk_tpu_torch/csrc/fused_lk_level.cu"
# Serving (apps/serve.py's accelerator configuration, ROADMAP's cell).
SB, SW, SH, SF = 64, 860, 483, 64     # streams, width, height, frames
# the source the processing size derives from: a 1080p dashcam resized to
# width 860 gives 483 rows (PipelineConfig.derived_height); staging holds
# frames at the processing size, so the pipeline runs no resize
SRC = (1920, 1080)
S_CHUNK, S_CAP = 16, 48
S_ZOOM = 1.03                          # tests/test_pipeline_e2e.py's scene
VP_ERR_LIMIT = 25.0                    # px, tests/test_pipeline_e2e.py:39
ROWS_TOL = 1e-4                        # px, kernel path vs plain path rows
KERNEL_TOL = 1e-6                      # kernel vs plain; 0 expected (the
                                       # kernels repeat the plain order)
# The single-stream VP pipeline (apps/_common.py run_vp_app's
# VideoPipeline): preset final, a 1080p source processed at 860x483, its
# default chunk of 16; 97 frames = the init frame + 6 chunks.
V_FRAMES, V_CHUNK = 97, 16
V_SPLIT = 1 + 3 * V_CHUNK              # frames before the checkpoint
# The apps (phases 18-20) on their --synthetic source, the package's
# 1280x720 stream (VP (0.5 w, 0.45 h) for the VP apps and the tracker
# apps, serve's per stream), processed at 860 px wide (960 for the
# tracker apps).
A_SRC = (1280, 720)
A_FRAMES = 1 + 3 * V_CHUNK             # phase 18: init + 3 chunks of 16
T_FRAMES = 1 + 2 * V_CHUNK             # phase 19
# Per-pair paths B and C (path A is lk_tpu_torch.entry's config; the
# geometry is printed from the port's own functions in phase 6).
PATH_CFGS = {
    "B": dict(use_pallas_warp=True, fused_grads_in_kernel=False),
    "C": dict(),                                             # DenseLKConfig()
}
# Paths B16 and C16: B with both bf16 options (bf16 A and b sums, the bf16
# window of the local warp), C with bf16 sums.
PATH_CFGS["B16"] = dict(PATH_CFGS["B"], bf16_box_sums=True,
                        bf16_warp_window=True)
PATH_CFGS["C16"] = dict(bf16_box_sums=True)
# f32 operations per output pixel, counted on the kernel bodies: pyrDown
# (9 per vertical-pass value at half the rows and all the columns, 9 per
# output: 6.75 per input pixel); the local warp (two tent passes of 15:
# clip d 2, add 1, clip to the level 2, two subtractions, clip to the
# window 2, floor 1, fraction 1, 1 - f 1, two products and a sum 3); one
# precomputed-level iteration (warp 30, residual 5, the two products 2,
# two 15x15 box sums 56, A v 8, solve 8, update and clip 6).
PYR_OPS_IN_PX = 6.75
WARP_OPS_PX = 30
PRE_OPS_PX = 115
# Device spins around a profiler trace (see traced_kernels): 5e7 clocks,
# ~25 ms at the H100's 1.98 GHz boost clock, at each end, the leading one
# cut into LEAD_SPINS kernels.
SPIN_CYCLES = 50_000_000
LEAD_SPINS = 8
# Peak rates of one H100 SXM (NVIDIA's data sheet) for the bounds.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per output pixel per iteration of the plain fused level
# (flow/lk_kernels.py _tile_step: Scharr 16, warp 32, residual and
# products 10, five 15x15 box sums 140, gate and solve 38)
LK_OPS_PX = 236
# The TPU kernel each variant of the one CUDA kernel stands in for
# (pallas_call line of its maker in lk_tpu/flow/pallas_kernels.py).
REPLACES = {
    "resident_batched": "lk_tpu/flow/pallas_kernels.py:1936",
    "batched": "lk_tpu/flow/pallas_kernels.py:1684",
    "resident": "lk_tpu/flow/pallas_kernels.py:1207",
    "tiled": "lk_tpu/flow/pallas_kernels.py:1382",
}
# Each variant's device ms at the 1080p plan shapes with the kernel's
# first design, before its redesign for Hopper (PERF.md's kernel table,
# rows 1-4, on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's.
FIRST_DESIGN_MS = {"resident_batched": 0.235, "batched": 1.756,
                   "resident": 0.203, "tiled": 0.485}
# The pyramid build's device time before its redesign as one launch (PERF.md
# section 5 and its kernel table, row 5, on an NVIDIA H100 80GB HBM3 at
# 700 W), printed beside this run's.
SEPARATE_PAD_MS = {
    "video chunk": "a 34-frame video's 10 builds took 0.450 ms of pyrDown "
                   "(30 launches) + 0.719 ms of the base's edge pad (20 "
                   "index_select launches)",
    "path A pair": "pyrDown 0.0241 ms (3 launches; 13.9 + 6.3 + 3.9 us), "
                   "the base's edge pad not timed alone",
}

# The finish and the precomputed level before their redesign for Hopper
# (PERF.md's kernel table, rows 8 and 10, PR 6's counted trace on an NVIDIA
# H100 80GB HBM3 at 700 W), printed beside this run's.
FINISH_PARENT = "one 1024x483x860 u8 chunk took 1.521 ms (PR 6's design)"
PRE_PARENT = "path B's top took 0.127 ms in 6 launches (PR 6's design)"
# The local warp's device us per level of path B with the kernel's first
# design, before its redesign for Hopper (PERF.md's kernel table, row 9, a
# counted trace on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's.
WARP_PARENT = {0: 25.6, 1: 9.7, 2: 6.5}


def configs():
    """The production config (bench.py's, and entry()'s path A):
    LKConfig defaults, DenseLKConfig(use_pallas_warp=True,
    pallas_pyramid=True)."""
    from lk_tpu_torch import entry

    return entry.CFG, entry.DENSE_CFG


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for moving nbytes and doing ops f32
    operations on one H100 at its published peaks."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device():
    import torch

    return torch.device("cuda", 0)


@contextlib.contextmanager
def patched(module, name, value):
    """Context: ``module.name`` rebound to ``value`` (the dense paths look
    their kernels' wrappers up at call time).  The per-pair CUDA graphs are
    dropped on entry and exit, so none captured with one binding replays
    under the other."""
    from lk_tpu_torch.flow import dense

    old = getattr(module, name)
    dense._pair_graphs.clear()
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)
        dense._pair_graphs.clear()


def plain_pyramid():
    """Context: the dense paths with the plain pyramid build, every other
    kernel unchanged."""
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.ops import blur

    return patched(dense, "build_pyramid", blur.build_pyramid_reference)


def plain_precomputed():
    """Context: the dense paths with the plain precomputed-A level, every
    other kernel unchanged."""
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import warp_kernels as wk

    return patched(dense, "fused_lk_level_precomputed",
                   wk.fused_lk_level_precomputed_reference)


def plain_local_warp():
    """Context: the dense paths with the plain local warp, every other
    kernel unchanged."""
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import warp_kernels as wk

    return patched(dense, "local_warp", wk.local_warp_reference)


def reset_counters() -> None:
    """Every kernel wrapper's launch and plain-call counts to 0."""
    from lk_tpu_torch.flow import lk_kernels, sparse, warp_kernels
    from lk_tpu_torch.geometry import vanishing
    from lk_tpu_torch.ops import blur, finish
    from lk_tpu_torch.pipeline import runner

    for module in (lk_kernels, finish, sparse, blur, warp_kernels,
                   vanishing, runner):
        module.reset_counters()


def dense_counts() -> tuple[dict, int]:
    """(launches by dense kernel, plain-version calls of the dense kernels)
    since the last reset_counters()."""
    from lk_tpu_torch.flow import lk_kernels as lk
    from lk_tpu_torch.flow import warp_kernels as wk
    from lk_tpu_torch.ops import blur

    counts = dict(lk.kernel_launches_by_variant, **wk.kernel_launches,
                  pyr_down=blur.kernel_launches)
    # the bf16 local warp's launches; scripts/torch_turns.py also runs
    # trees older than its counter
    by_window = getattr(wk, "local_warp_launches_by_window", None)
    if by_window is not None:
        counts["local_warp_bf16"] = by_window["bfloat16"]
    return counts, (lk.plain_calls + sum(wk.plain_calls.values())
                    + blur.plain_calls)


def timed_call(fn, *args, **kw):
    """(result, seconds) of fn on the host clock, synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_counts():
    """(launches of the apps' kernels, plain calls of every kernel)."""
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.geometry import vanishing
    from lk_tpu_torch.ops import blur, finish

    _, plain = dense_counts()
    return ({"pyr_down": blur.kernel_launches,
             "finish": finish.kernel_launches,
             "window_gather": sparse.kernel_launches,
             "vp_scan": vanishing.kernel_launches},
            plain + finish.plain_calls + sparse.plain_calls
            + vanishing.plain_calls)


def serving_launches(chunks: int, per_chunk: int = S_CHUNK,
                     passes: int = 1, graphs: dict | None = None) -> dict:
    """The launches kernel_counts() should read after ``passes`` serving
    passes of ``chunks`` chunks each, from how the chunks ran
    (runner.chunk_graph_counts since the last reset_counters()).  A chunk
    run op by op steps each of its frames from the host, and so does the
    capture of a key's frame graph once: the gather 3 times, the pyramid
    and the pair scan once per such step.  A replayed chunk launches none
    of them from the host.  The finish runs once a chunk and once for a
    pass's init frame, the pyramid once more a chunk for its seed.  Every
    chunk run op by op is a key's first, a whole one.  ``graphs``: another
    process's chunk_graph_counts."""
    from lk_tpu_torch.pipeline import runner

    c = runner.chunk_graph_counts if graphs is None else graphs
    check(c["eager"] + c["replays"] == passes * chunks,
          f"chunks ran {c}, expected {passes * chunks} in all")
    stepped = c["eager"] * per_chunk + c["captures"]
    return {"pyr_down": passes * chunks + stepped,
            "finish": passes * (chunks + 1),
            "window_gather": 3 * stepped, "vp_scan": stepped}


@contextlib.contextmanager
def plain_tracker_pyramid():
    """Context: the trackers' pyramid through its plain version, every
    chunk op by op (a frame graph replays the kernel it captured)."""
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.ops import blur
    from lk_tpu_torch.pipeline import runner

    old = runner.CHUNK_GRAPHS
    runner.CHUNK_GRAPHS = 0
    try:
        with patched(sparse, "build_pyramid", blur.build_pyramid_reference):
            yield
    finally:
        runner.CHUNK_GRAPHS = old


def single_stream_launches(chunks: int, first_tracked: int) -> int:
    """The tracker pyramid's and the pair scan's launches that
    kernel_counts() should read after a single-stream run of ``chunks``
    chunks, from how they ran (runner.video_graph_counts since the last
    reset_counters()).  A chunk run op by op launches each once per
    tracked frame, and so does the capture of a key's frame graph once; a
    replayed chunk launches none from the host.  Every chunk run op by op
    is a key's first, the run's first chunk of ``first_tracked``
    frames."""
    from lk_tpu_torch.pipeline import runner

    c = runner.video_graph_counts
    check(c["eager"] + c["replays"] == chunks and c["eager"] <= 1,
          f"single-stream chunks ran {c}, expected {chunks} in all, at "
          f"most the first op by op")
    return c["eager"] * first_tracked + c["captures"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_line() -> str:
    return sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]


# --------------------------------------------------------------------------
# synthetic scenes (bench.py's recipe, numpy/scipy only)
# --------------------------------------------------------------------------

def texture(rng, h, w):
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.random((h, w), dtype=np.float32) * 255, 2.0,
                          mode="mirror")
    img += gaussian_filter(rng.random((h, w), dtype=np.float32) * 255, 8.0,
                           mode="mirror")
    return (img - img.min()) / (img.max() - img.min()) * 255


def affine_video(rng, h, w, n, a):
    """n frames of a textured canvas under the affine map ``a`` (2x3,
    frame t+1 = frame t moved by a): frame t samples the canvas at
    a^-t(p).  Every pair's exact flow is a(p) - p."""
    from scipy.ndimage import map_coordinates

    m = 256                                     # canvas margin
    canvas = texture(rng, h + 2 * m, w + 2 * m)
    a3 = np.vstack([np.asarray(a, np.float64), [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(a3)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    frames = np.empty((n, h, w), np.float32)
    cur = np.eye(3)
    for t in range(n):
        src = cur @ pts
        frames[t] = map_coordinates(
            canvas, [src[1] + m, src[0] + m], order=1,
            mode="mirror").reshape(h, w)
        cur = inv @ cur
    return frames


def translation(dx, dy):
    return [[1.0, 0.0, dx], [0.0, 1.0, dy]]


def zoom_rotation(h, w, scale, angle_deg):
    """cv.getRotationMatrix2D((w/2, h/2), angle, scale)."""
    t = np.deg2rad(angle_deg)
    al, be = scale * np.cos(t), scale * np.sin(t)
    cx, cy = w / 2.0, h / 2.0
    return [[al, be, (1 - al) * cx - be * cy],
            [-be, al, be * cx + (1 - al) * cy]]


def mean_epe(flow, a, margin=40, step=16):
    """Mean EPE over all pairs on bench.py's grid [margin:-margin:step]."""
    hh, ww = flow.shape[1:3]
    ys, xs = np.mgrid[margin:hh - margin:step, margin:ww - margin:step]
    a = np.asarray(a)
    gx = a[0, 0] * xs + a[0, 1] * ys + a[0, 2] - xs
    gy = a[1, 0] * xs + a[1, 1] * ys + a[1, 2] - ys
    f = flow[:, ys, xs]
    return float(np.hypot(f[..., 0] - gx, f[..., 1] - gy).mean())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def level_calls(stacks, plan, cfg, k):
    """Per level, top first: (name, variant, args, kwargs) of the fused
    level calls of one chunk of k pairs (coarse inputs filled in later)."""
    import torch
    from lk_tpu_torch.flow.lk_kernels import variant

    top = len(plan) - 1
    calls = []
    for level in range(top, -1, -1):
        p = plan[level]
        st = stacks[level][:k + 1]
        kw = dict(tile_h=p.th, tile_w=p.tw, max_disp=p.disp, local=p.local,
                  n_iters=p.iters, coarse_in=level != top,
                  write_stats=level in (0, top),
                  min_eig_threshold=cfg.min_eig_threshold,
                  win_k=cfg.win_size[1])
        seed = torch.zeros((k, 2, p.h, p.w), dtype=torch.float32,
                           device=st.device) if level == top else None
        name = f"L{level} {p.h}x{p.w} tile {p.th}x{p.tw} x{p.iters}"
        calls.append((name, variant(k, p.h, p.w, p.th, p.tw, level != top),
                      st, seed, kw))
    return calls


def level_bound(k, h, w, kw):
    """Least time of one fused-level call: prev and next read once, the
    flow read once (half resolution when coarse-in) and written once, the
    stats (f32 + bool) written once; LK_OPS_PX per pixel per iteration."""
    px = k * h * w
    flow_in = px * 2 * 4 // (4 if kw["coarse_in"] else 1)
    nbytes = px * 4 * 2 + flow_in + px * 2 * 4 \
        + (px * 5 if kw["write_stats"] else 0)
    return bound(nbytes, px * kw["n_iters"] * LK_OPS_PX)


def compare_levels(stacks, plan, cfg, timing_reps):
    """Phase 2: kernel vs plain version per level, for K pairs and for one
    pair.  Every level reads the plain version's K-pair output of the level
    above (pair 0 of it for the single-pair run), so both sides see the
    same input.  Returns per-variant {max_abs_err, ms (device), event_ms,
    plain_ms, bound_ms, bound_by} and the per-level report rows (with the
    level's bound and whether flow, min_eig and valid equal the plain
    version's bit for bit)."""
    import torch
    from lk_tpu_torch.flow import lk_kernels as lk

    per_variant = {}
    rows = []
    chunk = {}                    # level name -> (kernel out, plain flow)
    for k in (K, 1):
        coarse = None
        for name, var, st, seed, kw in level_calls(stacks, plan, cfg, k):
            flow_in = seed if seed is not None else coarse
            args = (st[:-1], st[1:], flow_in)
            fk, mk, vk = lk.fused_lk_level(*args, **kw)
            fp, mp, vp = lk.fused_lk_level_reference(*args, **kw)
            torch.cuda.synchronize()
            err = float((fk - fp).abs().max())
            equal = torch.equal(fk, fp) and (mk is None or (
                torch.equal(mk, mp) and torch.equal(vk, vp)))
            check(bool(torch.isfinite(fk).all()), f"{name}: non-finite flow")
            check(err <= FLOW_TOL, f"{name} K={k}: max |dflow| {err} px")
            eig = flips = 0.0
            if mk is not None:
                scale = float(mp.abs().max())
                eig = float((mk - mp).abs().max()) / max(scale, 1e-30)
                flips = float((vk != vp).float().mean())
                check(eig <= EIG_REL_TOL, f"{name}: min_eig rel {eig}")
                check(flips <= FLIP_TOL, f"{name}: valid flips {flips}")
            if k == K:
                chunk[name] = ((fk, mk, vk), fp)
                coarse = fp
            else:         # single-pair output == chunk pair 0, bit for bit
                (cf, cm, cv), cp = chunk[name]
                check(torch.equal(fk[0], cf[0]),
                      f"{name}: K=1 flow differs from chunk pair 0")
                check(mk is None or (torch.equal(mk[0], cm[0])
                                     and torch.equal(vk[0], cv[0])),
                      f"{name}: K=1 stats differ from chunk pair 0")
                coarse = cp[:1]
            ms = cuda_ms(lambda: lk.fused_lk_level(*args, **kw), timing_reps)
            n_launch = {"fused_lk_level_kernel": kw["n_iters"]}
            dms = device_us(lambda: lk.fused_lk_level(*args, **kw),
                            n_launch) / 1e3
            shape_us = []          # each block shape, forced: same bits?
            for shape, _ in enumerate(lk.BLOCK_SHAPES):
                def forced(shape=shape):
                    return lk._fused_lk_level_cuda(*args, shape=shape, **kw)
                fs, fm, fv = forced()
                check(torch.equal(fs, fk) and (mk is None or (
                    torch.equal(fm, mk) and torch.equal(fv, vk))),
                      f"{name} K={k}: block shape {shape} changes the bits")
                shape_us.append(device_us(forced, n_launch))
            pms = cuda_ms(lambda: lk.fused_lk_level_reference(*args, **kw),
                          max(1, timing_reps // 10))
            b_ms, b_by = level_bound(k, *st.shape[1:], kw)
            rows.append((k, name, var, err, eig, flips, equal, dms, ms, pms,
                         b_ms, b_by, shape_us))
            v = per_variant.setdefault(
                var, {"max_abs_err": 0.0, "ms": 0.0, "event_ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}})
            v["max_abs_err"] = max(v["max_abs_err"], err)
            v["ms"] += dms
            v["event_ms"] += ms
            v["plain_ms"] += pms
            v["bound_ms"] += b_ms
            v["bound_by"][b_by] = v["bound_by"].get(b_by, 0.0) + b_ms
    return per_variant, rows


def spill_check(frames0, card):
    """Phase 2, the right-halo refresh: a tiled level whose tile width is
    not a multiple of 128 (272x480 on 136x480 tiles, 2 iterations) reads
    its second iteration's right halo from the current flow
    (warp_kernels.right_spill: 8 columns); kernel and plain version equal
    bit for bit, and differ from the same launches with no refresh."""
    import torch
    from lk_tpu_torch.flow import lk_kernels as lk
    from lk_tpu_torch.flow import warp_kernels as wk

    st = frames0[:2, :272, :480].contiguous()
    rng = np.random.default_rng(2)
    flow = torch.from_numpy(((rng.random((1, 2, 272, 480)) - 0.5) * 2.0)
                            .astype(np.float32)).to(st.device)
    kw = dict(tile_h=136, tile_w=480, max_disp=8, local=5, n_iters=2)
    fk, _, _ = lk.fused_lk_level(st[:1], st[1:], flow, **kw)
    fp, _, _ = lk.fused_lk_level_reference(st[:1], st[1:], flow, **kw)
    with patched(wk, "right_spill", lambda tile_w: 0):
        f0, _, _ = lk.fused_lk_level(st[:1], st[1:], flow, **kw)
    torch.cuda.synchronize()
    check(torch.equal(fk, fp), "the spill launch differs from its plain "
          "version")
    moved = float((fk - f0).abs().max())
    check(moved > 0.0, "the right-halo refresh changed nothing")
    print(f"[kernel] fused_lk_level tiled 272x480 on 136x480 tiles, 2 "
          f"iterations, right-halo refresh of {wk.right_spill(480)} columns:"
          f" bit-equal to the plain version; max |dflow| against no refresh "
          f"{moved:.3g} px  [{card}]")


def level_anatomy(stacks, plan, cfg, card, reps=20):
    """Phase 5 (--profile): the fused kernel at 1080p L0 (K pairs) against
    two copies of csrc/fused_lk_level.cu built for this measurement only
    (LK_FUSED_ANATOMY): one whose blocks return once their staging has
    landed, one without the copies.  If the kernel takes about the second's
    time, its passes bound it, not its copies."""
    import ctypes

    import torch
    from lk_tpu_torch import _build
    from lk_tpu_torch.flow import lk_kernels as lk

    out_dir = _build.build_dir()
    src = str(_build._PKG / _build.SOURCES[0])
    procs = {}
    for mode in (1, 2):
        so = out_dir / f"fused_lk_level_anatomy{mode}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DLK_FUSED_ANATOMY={mode}",
               "-shared", "-o", str(so), src]
        procs[mode] = (so, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for mode, (so, proc) in procs.items():
        _, err = proc.communicate()
        check(proc.returncode == 0, f"anatomy copy {mode}: {err[-2000:]}")
        libs[mode] = ctypes.CDLL(str(so))
        lk.bind(libs[mode])
    name, _, st, _, kw = level_calls(stacks, plan, cfg, K)[-1]
    k, h, w = st[:-1].shape
    coarse = torch.zeros((k, 2, h // 2, w // 2), dtype=torch.float32,
                         device=st.device)
    args = (st[:-1], st[1:], coarse)
    times = {"kernel": cuda_ms(lambda: lk.fused_lk_level(*args, **kw), reps)}
    real = _build._lib
    try:
        for mode, label in ((1, "staging only"), (2, "without the copies")):
            _build._lib = libs[mode]
            times[label] = cuda_ms(lambda: lk.fused_lk_level(*args, **kw),
                                   reps)
    finally:
        _build._lib = real
    print(f"[profile] fused level anatomy, K={k} {name}: " + ", ".join(
        f"{label} {ms:.4f} ms" for label, ms in times.items())
        + f"  [{card}]")


KERNEL_GROUPS = (("fused_lk_level_kernel", "fused_lk_level"),
                 ("pyramid_kernel", "pyramid_kernel"),
                 ("local_warp_kernel", "local_warp"),
                 ("fused_level_pre_kernel", "fused_level_pre"))


def kernel_group(name: str) -> str:
    """Report group of a device kernel's name."""
    for group, key in KERNEL_GROUPS:
        if key in name:
            return group
    return ("gather / index_select" if ("gather" in name or "index" in name)
            else "cat" if "Cat" in name
            else "elementwise (mul/add)" if "elementwise" in name
            else "other")


def traced_kernels(run, reps, launches=None):
    """The device kernels torch.profiler records over ``reps`` runs.

    ``launches`` ({name: launches of the kernels whose name holds it in
    one run}) is checked: each name's events must number ``reps`` times
    its launches, and a trace that misses any (or holds no device event
    at all) is taken once more before the check fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launches = launches or {}
    seen = {}
    # On the card the profiler can lose the first kernels of a trace: traces
    # of 10 launches held 9, 8 or 6 of them, one that began with a marker
    # kernel lost it and the first launch, one that began with one ~25 ms
    # spin lost it and the first launch, and more are lost once extra CUDA
    # modules are loaded.  So a trace begins with LEAD_SPINS short device
    # spins the host waits out and ends with a long one, none of them
    # returned; a trace that still misses a counted launch is taken once
    # more before the check fails.
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(SPIN_CYCLES // LEAD_SPINS)
            torch.cuda.synchronize()
            for _ in range(reps):
                run()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        everything = sorted((e for e in prof.events()
                             if e.device_type == DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
        kernels = [e for e in everything if "spin_kernel" not in e.name]
        seen = {name: sum(name in e.name for e in kernels)
                for name in launches}
        if kernels and all(seen[name] == reps * n
                           for name, n in launches.items()):
            return kernels
        t0 = everything[0].time_range.start if everything else 0
        print(f"[profile] an incomplete trace: {seen} of "
              f"{ {k: reps * n for k, n in launches.items()} }; its device "
              f"events (start us, name): " + "; ".join(
                  f"{e.time_range.start - t0:.0f} {e.name[:30]}"
                  for e in everything[:40]), file=sys.stderr)
    check(False, f"the profiler saw {len(kernels)} device events, of them "
          f"{seen} where {reps} runs launch "
          f"{ {k: reps * n for k, n in launches.items()} }")


def device_us(run, launches: dict, reps: int = 10) -> float:
    """Device time in us per run of the kernels named in ``launches``
    ({name: launches per run}; torch.profiler, reps runs after one
    warm-up, the launch count checked): a kernel's own time, which CUDA
    events around host-bound launches do not give."""
    import torch

    run()
    torch.cuda.synchronize()
    ks = [e for e in traced_kernels(run, reps, launches)
          if any(name in e.name for name in launches)]
    return sum(e.time_range.elapsed_us() for e in ks) / reps


def profile_run(label: str, run, card: str, reps: int = 3) -> None:
    """Phases 5 and 9 (--profile): where the device time of one run goes.
    Host enqueue and wall per run without the profiler, then a
    torch.profiler trace of ``reps`` runs: device ms per run by kernel
    group, and the busy share of the traced device span."""
    import torch

    run()
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[profile] {label}: host enqueue {enq * 1e3:.2f} ms, wall "
              f"{wall * 1e3:.2f} ms  [{card}]")
    kernels = traced_kernels(run, reps)
    groups = {}
    for e in kernels:
        group = kernel_group(e.name)
        n, us = groups.get(group, (0, 0.0))
        groups[group] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in groups.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    for group, (n, us) in sorted(groups.items(), key=lambda g: -g[1][1]):
        print(f"[profile] {label} {group}: {us / reps / 1e3:.3f} ms per run "
              f"({n // reps} launches), {us / busy:.1%} of device time  "
              f"[{card}]")
    print(f"[profile] {label}: device busy {busy / reps / 1e3:.3f} ms per "
          f"run, {len(kernels) // reps} launches, {busy / span:.1%} of the "
          f"traced device span ({span / reps / 1e3:.3f} ms per run)  "
          f"[{card}]")


# --------------------------------------------------------------------------
# per-pair dense paths: kernels vs plain, paths A/B/C, timing
# --------------------------------------------------------------------------

def path_cfg(name):
    from lk_tpu_torch import entry
    from lk_tpu_torch.config import DenseLKConfig

    if name == "A":
        return entry.DENSE_CFG
    return DenseLKConfig(**PATH_CFGS[name])


def path_levels(name, cfg):
    """Per level of a per-pair path at 1080p, as dense_flow_from_levels
    configures it: (level, (h, w), level DenseLKConfig, geometry)."""
    from lk_tpu_torch.flow import dense

    dcfg = path_cfg(name)
    ecfg = dense._effective_cfg(cfg, dcfg, (H, W))
    h, w = dense.pyramid_base_geometry(H, W, ecfg, dcfg)
    out = []
    for level, lcfg in enumerate(dense.level_configs(dcfg, ecfg.max_level)):
        out.append((level, (h, w), lcfg,
                    dense.pallas_level_geometry(h, w, lcfg)))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def zoom_flow(h, w, dev, outliers, seed=11):
    """(2, h, w) smooth zoom flow (+-0.01 px per px about the centre, plus
    a shift); with outliers, 1,000 pixels moved by up to +-40 px, beyond
    every +-local and some beyond max_disp."""
    import torch

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([(xs - w / 2) * 0.01 + 1.5, (ys - h / 2) * 0.01 - 1.0])
    if outliers:
        idx = rng.integers(0, h * w, 1000)
        flow.reshape(2, -1)[:, idx] += rng.uniform(-40, 40, (2, 1000))
    return torch.from_numpy(flow.astype(np.float32)).to(dev)


def perpair_kernels(frames0, cfg, card, reps=20):
    """Phase 6: the local warp and the precomputed level against their
    plain versions at path B's shapes, with ms per call, the plain ms, the
    bound and a library call; returns their report entries (launches
    filled later)."""
    import torch
    import torch.nn.functional as F
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import warp_kernels as wk
    from lk_tpu_torch.ops import blur

    dev = frames0.device

    def cmp(a, b, what):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite output")
        check(a.shape == b.shape, f"{what}: {tuple(a.shape)} vs "
              f"{tuple(b.shape)}")
        e = float((a - b).abs().max())
        check(e <= KERNEL_TOL, f"{what}: max|d| {e}")
        return e

    for name in ("A", "B"):
        for level, hw, lcfg, geo in path_levels(name, cfg):
            print(f"[geometry] path {name} L{level} {hw[0]}x{hw[1]}: "
                  f"iters {lcfg.outer_iters}, fused {lcfg.use_pallas_fused},"
                  f" grads in kernel {lcfg.fused_grads_in_kernel}, local "
                  f"{lcfg.warp_local}, disp {lcfg.level_disp(level)}; "
                  f"(resident, th, tw, hp, wp) = {geo}")

    # --- local warp: path B's L0-L2 at their padded shapes ------------------
    b_levels = path_levels("B", cfg)
    nxt_levels = dense.build_frame_levels(frames0[1], cfg, path_cfg("B"))
    ms_w = pms_w = lib_w = b_w = dev_w = 0.0
    err_w = 0.0
    by_w = set()
    # the bf16-window instances (bf16_warp_window) on the same levels
    w16 = dict(ms=0.0, pms=0.0, lib=0.0, b=0.0, dev=0.0, err=0.0, cast=0.0)
    by16 = set()
    top = None
    for level, (h, w), lcfg, (_, th, tw, hp, wp) in b_levels:
        nxt = blur.edge_pad(nxt_levels[level], hp, wp).contiguous()
        if lcfg.use_pallas_fused:
            top = (level, nxt, lcfg, th, tw, hp, wp)
            continue
        flow = zoom_flow(hp, wp, dev, outliers=True)
        kw = dict(max_disp=lcfg.level_disp(level), tile_h=th, tile_w=tw,
                  local=lcfg.warp_local)
        want = wk.local_warp_reference(nxt, flow, **kw)
        got = wk.local_warp(nxt, flow, **kw)
        e = cmp(got, want, f"local_warp L{level}")
        check(torch.equal(got, want), f"local_warp L{level}: differs from "
              f"the plain version")
        err_w = max(err_w, e)
        ms = cuda_ms(lambda: wk.local_warp(nxt, flow, **kw), reps)
        dev_us = device_us(lambda: wk.local_warp(nxt, flow, **kw),
                           {"local_warp_kernel": 1})
        dev_w += dev_us
        pms = cuda_ms(lambda: wk.local_warp_reference(nxt, flow, **kw), 3)
        ys, xs = torch.meshgrid(torch.arange(hp, device=dev),
                                torch.arange(wp, device=dev), indexing="ij")
        grid = torch.stack([(xs + flow[0]) * (2.0 / (wp - 1)) - 1.0,
                            (ys + flow[1]) * (2.0 / (hp - 1)) - 1.0],
                           -1)[None]
        img = nxt[None, None]
        lib = cuda_ms(lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=True), reps)
        bm, bb = bound(hp * wp * 16, hp * wp * WARP_OPS_PX)
        ms_w, pms_w, lib_w, b_w = ms_w + ms, pms_w + pms, lib_w + lib, \
            b_w + bm
        by_w.add(bb)
        print(f"[kernel] local_warp L{level} {hp}x{wp} tile {th}x{tw} local "
              f"{kw['local']} disp {kw['max_disp']}: torch.equal; kernel "
              f"device {dev_us:.1f} us (events {ms:.4f} ms), bound "
              f"{bm * 1e3:.2f} us ({bb}, {bm * 1e3 / dev_us:.0%} of it), "
              f"the parent's design {WARP_PARENT[level]} us; plain "
              f"{pms:.3f} ms, library F.grid_sample (2-D, no +-local "
              f"clamp) {lib:.4f} ms  [{card}]")
        # next rounded to bf16 once, outside the kernel, as the level does
        nxt16 = nxt.to(torch.bfloat16)
        kw16 = dict(kw, window_dtype=torch.bfloat16)
        want = wk.local_warp_reference(nxt16, flow, **kw16)
        got = wk.local_warp(nxt16, flow, **kw16)
        e = cmp(got, want, f"local_warp_bf16 L{level}")
        check(torch.equal(got, want), f"local_warp_bf16 L{level}: differs "
              f"from the plain version")
        check(torch.equal(got, wk.local_warp(nxt16.to(torch.float32), flow,
                                             **kw)),
              f"local_warp_bf16 L{level}: differs from the f32 instance on "
              f"the rounded plane")
        w16["err"] = max(w16["err"], e)
        ms = cuda_ms(lambda: wk.local_warp(nxt16, flow, **kw16), reps)
        dev_us16 = device_us(lambda: wk.local_warp(nxt16, flow, **kw16),
                             {"local_warp_kernel": 1})
        pms = cuda_ms(lambda: wk.local_warp_reference(nxt16, flow, **kw16),
                      3)
        cast = cuda_ms(lambda: nxt.to(torch.bfloat16), reps)
        img16 = nxt16.to(torch.float32)[None, None]
        lib = cuda_ms(lambda: F.grid_sample(
            img16, grid, mode="bilinear", padding_mode="border",
            align_corners=True), reps)
        bm, bb = bound(hp * wp * 14, hp * wp * WARP_OPS_PX)
        for k, v in (("ms", ms), ("pms", pms), ("lib", lib), ("b", bm),
                     ("dev", dev_us16), ("cast", cast)):
            w16[k] += v
        by16.add(bb)
        print(f"[kernel] local_warp_bf16 L{level} {hp}x{wp} (next bf16): "
              f"torch.equal to the plain version and to the f32 instance on "
              f"the rounded plane; kernel device {dev_us16:.1f} us (events "
              f"{ms:.4f} ms), bound {bm * 1e3:.2f} us ({bb}, "
              f"{bm * 1e3 / dev_us16:.0%} of it), the f32 instance "
              f"{dev_us:.1f} us in this call; the cast to bf16 (once per "
              f"level call, outside the kernel) {cast:.4f} ms (events); "
              f"plain {pms:.3f} ms, library F.grid_sample on the rounded "
              f"plane {lib:.4f} ms  [{card}]")
    print(f"[kernel] local_warp, path B's L0-L2 (3 launches): kernel "
          f"device {dev_w:.1f} us (events {ms_w:.4f} ms), bound "
          f"{b_w * 1e3:.2f} us ({b_w * 1e3 / dev_w:.0%} of it), the "
          f"parent's design {sum(WARP_PARENT.values()):.1f} us, plain "
          f"{pms_w:.3f} ms, library {lib_w:.4f} ms  [{card}]")
    print(f"[kernel] local_warp_bf16, path B16's L0-L2 (3 launches): kernel "
          f"device {w16['dev']:.1f} us (events {w16['ms']:.4f} ms), bound "
          f"{w16['b'] * 1e3:.2f} us ({w16['b'] * 1e3 / w16['dev']:.0%} of "
          f"it); the f32 instance {dev_w:.1f} us; the three casts "
          f"{w16['cast']:.4f} ms (events); plain {w16['pms']:.3f} ms, "
          f"library {w16['lib']:.4f} ms  [{card}]")

    # --- precomputed level: path B's top, and a tiled level -----------------
    prev_levels = dense.build_frame_levels(frames0[0], cfg, path_cfg("B"))
    level, nxt_top, lcfg, th, tw, hp, wp = top
    l1 = b_levels[1]
    cases = [(f"L{level} {hp}x{wp} tile {th}x{tw}", level, nxt_top, hp, wp,
              th, tw, lcfg.warp_local, lcfg.level_disp(level),
              lcfg.outer_iters),
             ("L1 576x1024 tile 64x512", 1,
              blur.edge_pad(nxt_levels[1], 576, 1024).contiguous(), 576,
              1024, 64, 512, l1[2].warp_local, l1[2].level_disp(1), 2)]
    entry = None
    err_f = 0.0
    for label, lv, nxt, hp, wp, th, tw, local, disp, iters in cases:
        prev = blur.edge_pad(prev_levels[lv], hp, wp).contiguous()
        ix, iy, a11, a12, a22, _, _, inv_det = dense.level_prologue(
            prev, cfg, "edge")
        flow = zoom_flow(hp, wp, dev, outliers=True) * 0.25
        args = (nxt, prev, ix, iy, a11, a12, a22, inv_det, flow)
        kw = dict(n_iters=iters, max_disp=disp, tile_h=th, tile_w=tw,
                  local=local, win_k=cfg.win_size[1])
        want = wk.fused_lk_level_precomputed_reference(*args, **kw)
        e = cmp(wk.fused_lk_level_precomputed(*args, **kw), want,
                f"fused_lk_level_precomputed {label}")
        err_f = max(err_f, e)
        ms = cuda_ms(lambda: wk.fused_lk_level_precomputed(*args, **kw),
                     reps)
        dev_us = device_us(lambda: wk.fused_lk_level_precomputed(
            *args, **kw), {"fused_level_pre_kernel": 1})
        pms = cuda_ms(lambda: wk.fused_lk_level_precomputed_reference(
            *args, **kw), 3)
        # each block shape forced, at the resident grid and at one block
        # per SM (regions then restaged every iteration): same bits
        variants = []
        for shape, (bh, bw) in enumerate(wk.PRE_BLOCK_SHAPES):
            for bps in (0, 1):
                def run(shape=shape, bps=bps):
                    return wk._fused_level_pre_cuda(
                        *args, **kw, shape=shape, blocks_per_sm=bps)
                check(torch.equal(run(), want), f"fused_lk_level_precomputed"
                      f" {label} {bh}x{bw} blocks_per_sm {bps}: differs")
                us = device_us(run, {"fused_level_pre_kernel": 1})
                variants.append(f"{bh}x{bw}{' 1/SM' if bps else ''} "
                                f"{us:.1f} us")
        # the 8 read-only planes and the initial flow read once, the flow
        # written once (the iterations' ping-pong stays in L2); the
        # operations once per iteration
        bm, bb = bound(hp * wp * (8 + 2 + 2) * 4,
                       iters * hp * wp * PRE_OPS_PX)
        print(f"[kernel] fused_lk_level_precomputed {label} x{iters} "
              f"(local {local}, disp {disp}): max|d| {e:.3g} px, torch.equal;"
              f" kernel device {dev_us:.1f} us in one launch (events "
              f"{ms:.4f} ms), plain {pms:.3f} ms, bound {bm:.5f} ms ({bb}); "
              f"each block shape and grid (same bits): {', '.join(variants)}"
              f"  [{card}]")
        if entry is None:            # path B's own call: the report entry
            entry = (dev_us / 1e3, ms, pms, bm, bb)
            one = device_us(lambda: wk.fused_lk_level_precomputed(
                *args, **dict(kw, n_iters=1)), {"fused_level_pre_kernel": 1})
            print(f"[kernel] fused_lk_level_precomputed {label}: "
                  f"{PRE_PARENT}; this run {dev_us:.1f} us: one iteration "
                  f"alone {one:.1f} us, each later one with its grid "
                  f"barrier {(dev_us - one) / (iters - 1):.1f} us  [{card}]")
    return [
        {"name": "local_warp", "route": "cuda",
         "source": "lk_tpu_torch/csrc/local_warp.cu",
         "replaces": "lk_tpu/flow/pallas_kernels.py:330",
         "max_abs_err": err_w, "ms": dev_w / 1e3, "event_ms": ms_w,
         "plain_ms": pms_w,
         "bound_ms": b_w,
         "bound_by": "bytes" if by_w == {"bytes"} else "operations",
         "library_ms": lib_w},
        {"name": "local_warp_bf16", "route": "cuda",
         "source": "lk_tpu_torch/csrc/local_warp.cu",
         "replaces": "lk_tpu/flow/pallas_kernels.py:330",
         "max_abs_err": w16["err"], "ms": w16["dev"] / 1e3,
         "event_ms": w16["ms"], "plain_ms": w16["pms"], "bound_ms": w16["b"],
         "bound_by": "bytes" if by16 == {"bytes"} else "operations",
         "library_ms": w16["lib"]},
        {"name": "fused_lk_level_precomputed", "route": "cuda",
         "source": "lk_tpu_torch/csrc/fused_level_pre.cu",
         "replaces": "lk_tpu/flow/pallas_kernels.py:2040",
         "max_abs_err": err_f, "ms": entry[0], "event_ms": entry[1],
         "plain_ms": entry[2], "bound_ms": entry[3], "bound_by": entry[4],
         "library_ms": None},
    ]


def pyramid_bound(n, hw, pad, levels):
    """Least time of one pyramid build: the f32 frames read once, the
    padded base (if any) and every level written once; PYR_OPS_IN_PX per
    input pixel of each level."""
    (h, w), (hp, wp) = hw, pad
    nbytes = n * h * w * 4 + (n * hp * wp * 4 if (hp, wp) != (h, w) else 0)
    ops = 0.0
    for _ in range(levels):
        ops += n * hp * wp * PYR_OPS_IN_PX
        hp, wp = (hp + 1) // 2, (wp + 1) // 2
        nbytes += n * hp * wp * 4
    return bound(nbytes, ops)


def pyramid_phase(frames0, cfg, card, reps=20):
    """Phase 6a: the pyramid build against its plain version at four
    shapes: the video's chunk (K+1 frames padded to the 1080p plan's base),
    path A's pair, the serving tracker's batch at its levels (no pad) and
    an odd stack.  At each: every level torch.equal; the kernel's device
    time (counted torch.profiler), its CUDA-event time, the plain time,
    the bound; the parent's composition (edge pad, then one pyrDown call
    per level, here the kernel's one-level form) and the library
    (F.pad replicate + one nn.Conv2d 5x5 stride 2 reflect per level),
    both timed in this call.  Returns the report entry (the video chunk's
    numbers; launches filled later)."""
    import torch
    import torch.nn.functional as F
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.ops import blur

    dev = frames0.device
    pad = dense.pyramid_base_geometry(H, W, cfg, path_cfg("A"))
    top = dense._effective_cfg(cfg, path_cfg("A"), (H, W)).max_level
    s_levels = serving_config().lk.max_level
    rng = np.random.default_rng(3)
    cases = [
        ("video chunk", frames0[:K + 1], pad, top),
        ("path A pair", frames0[:2], pad, top),
        ("serving tracker batch", torch.from_numpy(rng.random(
            (SB, SH, SW), dtype=np.float32) * 255).to(dev), None, s_levels),
        ("odd stack", torch.from_numpy(rng.random(
            (3, 483, 861), dtype=np.float32) * 255).to(dev), None, 3),
    ]
    g5 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev) / 16.0
    conv = torch.nn.Conv2d(1, 1, 5, stride=2, padding=2,
                           padding_mode="reflect", bias=False).to(dev)
    entry = None
    err = 0.0
    with torch.no_grad():
        conv.weight.copy_((g5[:, None] * g5[None, :])[None, None])
        for label, x, pad_hw, levels in cases:
            n, h, w = x.shape
            hp, wp = pad_hw or (h, w)
            padded = (hp, wp) != (h, w)

            def kernel(x=x, pad_hw=pad_hw, levels=levels):
                return blur.build_pyramid(x, levels, pad_hw)

            def parent(x=x, hp=hp, wp=wp, levels=levels):
                lv = blur.edge_pad(x, hp, wp)
                for _ in range(levels):
                    lv = blur.pyr_down(lv)

            def library(x=x, levels=levels):
                y = x[:, None]
                if padded:
                    y = F.pad(y, (0, wp - w, 0, hp - h), mode="replicate")
                out = [y]
                for _ in range(levels):
                    out.append(conv(out[-1]))
                return out

            got = kernel()
            want = blur.build_pyramid_reference(x, levels, pad_hw)
            lib_out = library()
            torch.cuda.synchronize()
            check(len(got) == len(want) == levels + 1,
                  f"pyramid {label}: {len(got)} levels")
            for i, (g, wt) in enumerate(zip(got, want)):
                check(g.shape == wt.shape and bool(torch.isfinite(g).all()),
                      f"pyramid {label} L{i}: {tuple(g.shape)} vs "
                      f"{tuple(wt.shape)}")
                d = float((g - wt).abs().max())
                err = max(err, d)
                check(torch.equal(g, wt), f"pyramid {label} L{i}: not equal "
                      f"to the plain version (max|d| {d})")
            lib_err = max(float((o[:, 0] - g).abs().max())
                          for o, g in zip(lib_out, got))
            dms = device_us(kernel, {"pyramid_kernel": 1}) / 1e3
            ms = cuda_ms(kernel, reps)
            pms = cuda_ms(lambda: blur.build_pyramid_reference(
                x, levels, pad_hw), 3)
            par = device_us(parent, {"pyramid_kernel": levels,
                                     "gather_elementwise": 2 if padded else 0}
                            ) / 1e3
            par_ms = cuda_ms(parent, reps)
            lib = cuda_ms(library, reps)
            bm, bb = pyramid_bound(n, (h, w), (hp, wp), levels)
            print(f"[kernel] pyramid {label} {tuple(x.shape)} -> base "
                  f"{hp}x{wp} + {levels} levels: torch.equal on every level;"
                  f" kernel device {dms:.4f} ms (events {ms:.4f}), bound "
                  f"{bm:.4f} ms ({bb}), at {bm / dms:.1%} of the bound; "
                  f"parent composition device {par:.4f} ms (the edge pad's "
                  f"{2 if padded else 0} gathers + {levels} one-level "
                  f"launches; events, with the pad's index builds, "
                  f"{par_ms:.4f}); plain {pms:.3f} ms; "
                  f"library F.pad + nn.Conv2d 5x5 stride 2 reflect per level"
                  f" {lib:.4f} ms (max|d| {lib_err:.3g}); 1 launch  [{card}]")
            if label in SEPARATE_PAD_MS:
                print(f"[kernel] pyramid {label}, before the one-launch "
                      f"design: {SEPARATE_PAD_MS[label]}  "
                      f"[NVIDIA H100 80GB HBM3, 700.00 W]")
            if entry is None:        # the video chunk: the report entry
                # the grid, capped below the resident maximum: same bits?
                caps = []
                for cap in (1, 2, 4):
                    def capped(cap=cap):
                        return blur._pyramid_cuda(x, levels, pad_hw,
                                                  blocks_per_sm=cap)
                    check(all(torch.equal(a, b)
                              for a, b in zip(capped(), got)),
                          f"pyramid {label}: {cap} blocks per SM changes "
                          f"the bits")
                    caps.append(f"{cap} per SM "
                                f"{device_us(capped, {'pyramid_kernel': 1}):.1f}"
                                f" us")
                print(f"[kernel] pyramid {label}, grid capped (same bits): "
                      f"{', '.join(caps)}; resident maximum {dms * 1e3:.1f}"
                      f" us  [{card}]")
                # the build cut after each level: what each level adds
                cut = [f"{n_lv} level{'s' if n_lv > 1 else ''} "
                       f"{device_us(lambda n_lv=n_lv: blur.build_pyramid(x, n_lv, pad_hw), {'pyramid_kernel': 1}):.1f} us"
                       for n_lv in range(1, levels)]
                print(f"[kernel] pyramid {label}, cut after each level: "
                      f"{', '.join(cut)}, {levels} levels "
                      f"{dms * 1e3:.1f} us  [{card}]")
                entry = {"name": "pyr_down", "route": "cuda",
                         "source": "lk_tpu_torch/csrc/pyr_down.cu",
                         "replaces": "lk_tpu/flow/pallas_kernels.py:2660",
                         "ms": dms, "event_ms": ms, "plain_ms": pms,
                         "bound_ms": bm, "bound_by": bb, "library_ms": lib,
                         "parent_ms": par}
            del got, want, lib_out
    entry["max_abs_err"] = err
    return entry


EXPECT = {   # launches per pair at 1080p; every other count 0
    "A": {"pyr_down": 1, "resident": 6, "tiled": 3},
    "B": {"pyr_down": 1, "local_warp": 3, "fused_lk_level_precomputed": 1},
    "B16": {"pyr_down": 1, "local_warp": 3, "local_warp_bf16": 3,
            "fused_lk_level_precomputed": 1},
    "C": {"pyr_down": 1},
    "C16": {"pyr_down": 1},
}


# EXPECT's counters by the kernel names of a device trace
TRACE_NAMES = {"pyr_down": "pyramid_kernel", "resident": "fused_lk_level",
               "tiled": "fused_lk_level", "local_warp": "local_warp",
               "fused_lk_level_precomputed": "fused_level_pre"}


def counted(name, fn, *args):
    """fn(*args) with the counters reset just before and read just after;
    checks path ``name``'s launches and that no plain version ran.  A
    per-pair CUDA graph's replay counts only its level 0: ``fn`` is a key's
    first or capturing call here, and ``replayed`` checks a replay."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    out = fn(*args)
    torch.cuda.synchronize()
    counts, plain = dense_counts()
    want = {k: EXPECT[name].get(k, 0) for k in counts}
    check(plain == 0, f"path {name}: plain versions ran {plain}x")
    check(counts == want, f"path {name}: launches {counts}, expected {want}")
    return out, {k: n for k, n in counts.items() if n}


def replayed(name, run):
    """Path ``name``'s launches in a device trace of a call of ``run`` that
    replays the per-pair CUDA graph (the kernel wrappers count only the
    launches they make, level 0's on a replay)."""
    from lk_tpu_torch.flow import dense

    launches = {}
    for k, n in EXPECT[name].items():
        if k in TRACE_NAMES:
            launches[TRACE_NAMES[k]] = launches.get(TRACE_NAMES[k], 0) + n
    run()                      # captures, if no call has yet
    before = dense.pair_graph_counts["replays"]
    traced_kernels(run, 1, launches)
    check(dense.pair_graph_counts["replays"] > before,
          f"path {name}: the traced call did not replay a CUDA graph")
    return launches


def perpair_paths(scenes, video_pair0, cfg, card):
    """Phases 7-8: paths A (through entry()), B, B16, C and C16 on both
    scenes' first pair; returns the launch counts of each path's first
    scene."""
    import torch
    from lk_tpu_torch.entry import entry
    from lk_tpu_torch.flow import dense

    fn, args = entry()
    flow, counts = counted("A", fn, *args)
    check(tuple(flow.shape) == (H, W, 2), f"entry flow {tuple(flow.shape)}")
    check(bool(torch.isfinite(flow).all()), "entry: non-finite flow")
    print(f"[path A] entry() on its rng(0) noise pair: flow "
          f"{tuple(flow.shape)}, finite, launches {counts}, plain calls 0")
    del args
    result = {}
    for label, a, frames_np in scenes:
        pair = torch.from_numpy(frames_np[:2]).to(device())
        flow, counts = counted("A", fn, pair[0], pair[1])
        result.setdefault("A", counts)
        traced = replayed("A", lambda: fn(pair[0], pair[1]))
        with plain_pyramid():
            same_plain = torch.equal(fn(pair[0], pair[1]), flow)
        check(same_plain, f"path A {label}: the flow differs with the plain "
              f"pyramid")
        epe = mean_epe(flow[None].cpu().numpy(), a)
        same = torch.equal(flow, video_pair0[label])
        d = float((flow - video_pair0[label]).abs().max())
        print(f"[path A] {label}: launches {counts} (replayed, traced: "
              f"{traced}), plain calls 0, mean EPE {epe:.4f} px (limit "
              f"{EPE_LIMIT}); == the run with the "
              f"plain pyramid: {same_plain}; == video chain pair 0: {same} "
              f"(max|d| {d:.3g} px)")
        check(epe < EPE_LIMIT, f"path A {label}: EPE {epe}")
        check(same, f"path A {label}: per-pair flow differs from the video "
              f"chain's pair 0 by {d} px")
        epes = {}
        for name in ("B", "B16", "C", "C16"):
            res, counts = counted(name, dense.dense_pyramidal_lk, pair[0],
                                  pair[1], cfg, None, path_cfg(name))
            traced = replayed(name, lambda: dense.dense_pyramidal_lk(
                pair[0], pair[1], cfg, None, path_cfg(name)))
            result.setdefault(name, counts)
            flow = res.flow
            check(tuple(flow.shape) == (H, W, 2)
                  and bool(torch.isfinite(flow).all()),
                  f"path {name} {label}: flow {tuple(flow.shape)}")
            epe = epes[name] = mean_epe(flow[None].cpu().numpy(), a)
            limit = f" (limit {EPE_LIMIT})" if name != "C" else ""
            if name in ("B16", "C16"):
                limit += f"; {name[0]}'s {epes[name[0]]:.4f} px"
            same = ""
            if name in ("B", "B16"):
                for what, plain in (("precomputed level",
                                     plain_precomputed),
                                    ("local warp", plain_local_warp)):
                    with plain():
                        ref = dense.dense_pyramidal_lk(
                            pair[0], pair[1], cfg, None, path_cfg(name))
                    check(all(torch.equal(x, y) for x, y in zip(res, ref)),
                          f"path {name} {label}: the flow, min_eig or valid "
                          f"differ with the plain {what}")
                same = (", flow, min_eig and valid == the runs with the "
                        "plain precomputed level and with the plain local "
                        "warp")
            print(f"[path {name}] {label}: launches {counts} (replayed, "
                  f"traced: {traced}), plain calls 0, valid "
                  f"{float(res.valid.float().mean()):.4f}, mean EPE "
                  f"{epe:.4f} px{limit}{same}")
            if name != "C":
                check(epe < EPE_LIMIT, f"path {name} {label}: EPE {epe}")
    return result


def perpair_timing(frames0, cfg, card, profile):
    """Phase 9: ms per pair of paths A, B, B16, C and C16 (CUDA events,
    warm); with --profile also each path's host enqueue and device
    breakdown."""
    from lk_tpu_torch.flow import dense

    f0, f1 = frames0[0], frames0[1]
    for name, reps in (("A", 20), ("B", 10), ("B16", 10), ("C", 5),
                       ("C16", 5)):
        dcfg = path_cfg(name)

        def run():
            dense.dense_pyramidal_lk(f0, f1, cfg, dense_cfg=dcfg)

        run()        # the key's first call runs op by op; cuda_ms's
        dense.reset_counters()     # warm-up captures the CUDA graph
        ms = cuda_ms(run, reps)
        c = dense.pair_graph_counts
        print(f"[time] path {name} dense_pyramidal_lk {H}x{W}: {ms:.3f} ms "
              f"per pair = {1e3 / ms:.1f} pairs/s, CUDA graph replays "
              f"{c['replays']} of {c['replays'] + c['eager']} calls  "
              f"[{card}]")
        if profile:
            profile_run(f"path {name} pair", run, card)


# --------------------------------------------------------------------------
# the rest of lk_tpu's surface on the card
# --------------------------------------------------------------------------

def surface_phase(frames0, cfg, dcfg, card):
    """Phase 25: each function the port added last, on card tensors, against
    the same call on CPU tensors (the plain versions), and the 1080p video
    with padded_build equal to phase 4's video bit for bit."""
    import dataclasses

    import torch
    from lk_tpu_torch import ops
    from lk_tpu_torch.config import PipelineConfig
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.geometry import classify, vanishing
    from lk_tpu_torch.ops import blur, resize
    from lk_tpu_torch.utils import Timer

    frame = frames0[0]
    cpu = frame.cpu()
    results = []

    def same(name, got, want, tol, note=""):
        """got (card) against want (CPU); tol 0: torch.equal."""
        got = [got] if torch.is_tensor(got) else list(got)
        want = [want] if torch.is_tensor(want) else list(want)
        check(len(got) == len(want), f"{name}: {len(got)} vs {len(want)}")
        err = 0.0
        for g, w in zip(got, want):
            g = g.cpu()
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
                  f"{w.dtype}")
            if g.dtype == torch.bool or not g.is_floating_point():
                check(torch.equal(g, w), f"{name}: differs")
                continue
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite")
            err = max(err, float((g - w).abs().max()))
            if tol == 0:
                check(torch.equal(g, w), f"{name}: not equal (max|d| {err})")
        check(err <= tol, f"{name}: max|d| {err} > {tol}")
        results.append(f"{name} {'torch.equal' if tol == 0 else f'max|d| {err:.3g} (tol {tol:g}{note})'}")

    torch.cuda.synchronize()
    reset_counters()
    got = ops.gaussian_pyramid(frame, 3)
    torch.cuda.synchronize()
    check(blur.kernel_launches == 1 and blur.plain_calls == 0,
          f"gaussian_pyramid: {blur.kernel_launches} launches, "
          f"{blur.plain_calls} plain calls")
    same("gaussian_pyramid (1 launch)", got, ops.gaussian_pyramid(cpu, 3), 0)
    # f32 products summed in another order on the card (TF32 off)
    same(f"resize_linear {H}x{W} -> {H // 2}x{W // 2}",
         ops.resize_linear(frame, H // 2, W // 2),
         ops.resize_linear(cpu, H // 2, W // 2), 1e-3, ", matmul order")
    same("imutils_width_resize -> 860 wide",
         resize.imutils_width_resize(frame, 860),
         resize.imutils_width_resize(cpu, 860), 1e-3, ", matmul order")
    check(resize.linear_weights(1080, 540) is resize.linear_weights(1080, 540),
          "linear_weights is not cached")
    for c in ((960.4, 540.8), (3.3, 1.7), (-5.5, 1079.2)):
        cen = torch.tensor(c, dtype=torch.float32)
        same(f"extract_patch {c}", ops.extract_patch(frame, cen.to(frame.device),
                                                     (15, 15)),
             ops.extract_patch(cpu, cen, (15, 15)), 0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    radial = np.stack([(xs - W / 2) * 0.01, (ys - H / 2) * 0.01], -1)
    flow = torch.from_numpy(radial + np.random.default_rng(5).normal(
        0, 0.3, radial.shape).astype(np.float32))
    vp = torch.tensor([W / 2, H / 2], dtype=torch.float32)
    valid = torch.from_numpy(np.random.default_rng(6).random((H, W)) < 0.9)
    g = classify.classify_dense_flow(flow.to(frame.device),
                                     vp.to(frame.device),
                                     valid.to(frame.device))
    w = classify.classify_dense_flow(flow, vp, valid)
    # labels elementwise (correctly rounded sqrt and division on both);
    # fractions are sums of 0/1 below 2**24 (exact); the mean speeds are
    # reductions in another order: 1e-5 relative
    same("classify_dense_flow labels and fractions",
         (g.labels, g.frac_static, g.frac_away, g.frac_toward,
          g.frac_lateral),
         (w.labels, w.frac_static, w.frac_away, w.frac_toward,
          w.frac_lateral), 0)
    for k in ("mean_radial", "mean_tangential"):
        a, b = float(getattr(g, k)), float(getattr(w, k))
        check(abs(a - b) <= 1e-5 * abs(b) + 1e-7, f"{k}: {a} vs {b}")
    results.append("classify_dense_flow mean speeds within 1e-5 relative")
    pcfg = PipelineConfig()
    rng = np.random.default_rng(7)
    n = 8
    t = np.float32(np.linspace(-1, 1, pcfg.vp_ref))
    hist = np.stack([np.stack([430 + 40 * t + rng.normal(0, 2, t.shape),
                               240 + 25 * t + rng.normal(0, 2, t.shape)], -1)
                     for _ in range(n)]).astype(np.float32)
    totals = np.array([0, 1, 2, 17, 299, 300, 301, 1000], np.int64)
    state = vanishing.init_vp_state(pcfg, n, device="cpu")._replace(
        hist_xy=torch.from_numpy(hist), hist_total=torch.from_numpy(totals),
        vp_xy=torch.from_numpy(hist[:, 5].copy()),
        vp_moved=torch.from_numpy(totals > 2))
    on_card = vanishing.VPState(*(x.to(frame.device) for x in state))
    (lp, rp, up, dp), ok = vanishing.vanishing_lines(on_card, pcfg, (860, 483))
    (lp0, rp0, up0, dp0), ok0 = vanishing.vanishing_lines(state, pcfg,
                                                          (860, 483))
    check(torch.equal(ok.cpu(), ok0) and bool(ok0[3:].all())
          and not bool(ok0[:3].any()), f"vanishing_lines ok {ok0.tolist()}")
    for a, b in zip((lp, rp, up, dp), (lp0, rp0, up0, dp0)):
        a = a.cpu()[ok0]
        b = b[ok0]
        check(bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-3).all()),
              f"vanishing_lines endpoints {a} vs {b}")
    results.append("vanishing_lines (8 streams) ok equal, endpoints within "
                   "1e-5 relative + 1e-3 px (regressions summed in another "
                   "order)")
    pad_cfg = dataclasses.replace(dcfg, padded_build=True)
    torch.cuda.synchronize()
    reset_counters()
    with Timer() as t_pad:
        padded = dense.dense_pyramidal_lk_video(frames0, cfg, pad_cfg)
        torch.cuda.synchronize()
    counts, plain = dense_counts()
    check(plain == 0 and counts["pyr_down"] == VIDEO_PYRAMIDS,
          f"padded_build video: launches {counts}, plain calls {plain}")
    ref = dense.dense_pyramidal_lk_video(frames0, cfg, dcfg)
    check(all(torch.equal(a, b) for a, b in zip(padded, ref)),
          "the padded_build video differs from phase 4's video")
    results.append(f"the 1080p video with padded_build == phase 4's video "
                   f"(flow, min_eig, valid; {VIDEO_PYRAMIDS} pyramid "
                   f"launches, Timer {t_pad.dt:.3f} s)")
    for r in results:
        print(f"[surface] {r}  [{card}]")


# --------------------------------------------------------------------------
# serving: scenes, main path, kernels vs plain, timing, profile
# --------------------------------------------------------------------------

def road_staging(dev, n_streams=SB, n_frames=SF, h=SH, w=SW, zoom=S_ZOOM,
                 first=0):
    """(n_frames, n_streams, h, w) u8 staging of forward-driving scenes:
    stream s (from ``first``) is the package's
    ``lk_tpu_torch.io.video.SyntheticRoadStream`` (seed s, apps/serve.py's
    VP (0.45 + 0.01 (s % 5)) w, 0.45 h), gray, rendered on the card; and
    the planted VPs."""
    import torch
    from lk_tpu_torch.io.video import SyntheticRoadStream

    out = torch.empty((n_frames, n_streams, h, w), dtype=torch.uint8,
                      device=dev)
    vps = []
    for s in range(first, first + n_streams):
        vp = (w * (0.45 + 0.01 * (s % 5)), h * 0.45)
        scene = SyntheticRoadStream(width=w, height=h, vp=vp, zoom=zoom,
                                    seed=s, n_frames=n_frames, color=False,
                                    device=dev)
        out[:, s - first] = scene.gray_frames(0, n_frames)
        vps.append(vp)
    return out, np.array(vps)


def serving_config():
    import dataclasses

    from lk_tpu_torch.models import PRESETS

    return dataclasses.replace(PRESETS["final"], out_cap=S_CAP)


def serve_pass(staging, n_streams=SB, mesh=None):
    """One serving pass: a fresh MultiStreamPipeline fed the whole staging
    array in chunks (the first one chunk + the init frame), then drained.
    With a ``mesh`` the pipeline's streams shard over its "streams" axis
    and ``staging`` holds this rank's streams."""
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    # ``mesh`` only when given: scripts/torch_turns.py runs this pass on
    # trees whose pipeline predates it
    ms = MultiStreamPipeline(serving_config(), src_size=SRC,
                             n_streams=n_streams, chunk=S_CHUNK,
                             **({} if mesh is None else {"mesh": mesh}))
    check((ms.height, ms.width) == (SH, SW) == tuple(staging.shape[2:]),
          f"processing size {ms.height}x{ms.width}, staging "
          f"{tuple(staging.shape[2:])}")
    t, f = 0, staging.shape[0]
    while t < f:
        n = min(S_CHUNK + (1 if ms.states is None else 0), f - t)
        ms.feed_staged(staging, t, n)
        t += n
    ms.drain()
    return ms


def n_chunks(f=SF) -> int:
    return -(-(f - 1) // S_CHUNK)


def plain_versions():
    """Context: the serving path through the plain versions (module
    attributes the path looks up at call time), for comparison runs, every
    chunk op by op (the plain pair scan reads its trip count from the
    device, so no frame graph can capture it)."""
    import contextlib

    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.geometry import vanishing
    from lk_tpu_torch.ops import blur, finish
    from lk_tpu_torch.pipeline import runner, step

    @contextlib.contextmanager
    def ctx():
        old = (finish.fused_finish, sparse.gather_windows,
               sparse.build_pyramid, step.process_frame_pairs,
               runner.CHUNK_GRAPHS)
        finish.fused_finish = finish.fused_finish_reference
        sparse.gather_windows = sparse.gather_windows_reference
        sparse.build_pyramid = blur.build_pyramid_reference
        step.process_frame_pairs = vanishing.process_frame_pairs_reference
        runner.CHUNK_GRAPHS = 0
        try:
            yield
        finally:
            (finish.fused_finish, sparse.gather_windows,
             sparse.build_pyramid, step.process_frame_pairs,
             runner.CHUNK_GRAPHS) = old

    return ctx()


def vp_errors(ms, vps):
    """Per stream with VP output, |mean of the late half of the csv
    trajectory - planted VP| in px."""
    errs = []
    for p, gt in zip(ms.pipes, vps):
        rows = np.array(p.csv_rows, np.float64)
        if len(rows):
            errs.append(float(np.linalg.norm(
                rows[len(rows) // 2:].mean(0) - gt)))
    return errs


def serving_main_path(staging, vps, card):
    """Phase 11: the counted serving pass, its checks, and the 4-stream
    plain-path comparison.  Returns (launch counts, the pass)."""
    import torch
    from lk_tpu_torch.pipeline import runner

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ms = serve_pass(staging)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = kernel_counts()
    want = serving_launches(n_chunks())
    frames = SF - 1
    print(f"[serve] B={SB} {SW}x{SH} chunk {S_CHUNK} out_cap {S_CAP} preset "
          f"final, {SF} staged frames: chunks {runner.chunk_graph_counts}, "
          f"launches {launches}, plain calls {plain}, first pass "
          f"{wall:.2f} s (incl. warm-up)  [{card}]")
    check(plain == 0, f"plain versions ran {plain}x on the card")
    check(launches == want, f"launches {launches}, expected {want}")
    check(all(p.frames_done == frames for p in ms.pipes),
          "a stream did not run every frame")
    rows = [np.array(p.csv_rows, np.float64) for p in ms.pipes]
    check(all(np.isfinite(r).all() for r in rows), "non-finite csv rows")
    with_vp = sum(1 for r in rows if len(r))
    errs = vp_errors(ms, vps)
    mean_err = float(np.mean(errs)) if errs else float("inf")
    print(f"[serve] streams with VP output: {with_vp}/{SB}; late-trajectory "
          f"VP error vs planted: mean {mean_err:.2f} px, max "
          f"{max(errs):.2f} px (limit {VP_ERR_LIMIT} on the mean); csv rows "
          f"per stream {min(map(len, rows))}..{max(map(len, rows))}")
    check(with_vp >= SB // 2, f"only {with_vp} streams found a VP")
    check(mean_err < VP_ERR_LIMIT, f"mean VP error {mean_err} px")

    sub = staging[:, :4].contiguous()
    with plain_versions():
        ref = serve_pass(sub, n_streams=4)
    torch.cuda.synchronize()
    worst = 0.0
    for b in range(4):
        a = np.array(ms.pipes[b].csv_rows, np.float64).reshape(-1, 2)
        r = np.array(ref.pipes[b].csv_rows, np.float64).reshape(-1, 2)
        check(a.shape == r.shape,
              f"stream {b}: {len(a)} csv rows vs {len(r)} on the plain path")
        if len(a):
            worst = max(worst, float(np.abs(a - r).max()))
        check([v is None for v in ms.pipes[b].vp_per_frame]
              == [v is None for v in ref.pipes[b].vp_per_frame],
              f"stream {b}: shown frames differ on the plain path")
    print(f"[serve] streams 0-3 through the plain versions on the card: same "
          f"csv row counts, max |drow| {worst:.3g} px (tolerance {ROWS_TOL})")
    check(worst <= ROWS_TOL, f"csv rows differ by {worst} px")
    return launches, ms


def record_calls(staging, module, name, steps):
    """The calls of ``module.name`` in the first ``steps`` frame steps of
    the 64-stream batch, taken by a recording wrapper around the kernel's
    wrapper, the chunk run op by op (a frame graph's capture passes
    tensors that hold no values yet); the steps' outputs are not
    drained."""
    from lk_tpu_torch.pipeline import runner

    calls = []
    real = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    with patched(runner, "CHUNK_GRAPHS", 0), patched(module, name, rec):
        runner.MultiStreamPipeline(serving_config(), src_size=SRC,
                                   n_streams=SB, chunk=S_CHUNK).feed_staged(
            staging, 0, steps + 1)
    return calls


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32: -0 is not
    +0, and a NaN equals a NaN of the same payload)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def scan_bound(state, new, cps, cand, out):
    """Least time of one pair-scan call: its inputs read once and its
    outputs written once (the carry stays on chip), and ~30 f32
    operations per ring slot of each candidate's step (the ring's masked
    sums, its variance, the keep test and the kept sum)."""
    nbytes = sum(x.numel() * x.element_size()
                 for x in (*state, *new, cps, cand, *out))
    steps = int(cand.sum())
    return bound(nbytes, steps * state.ring_xy.shape[1] * 30)


def gather_bound(n, win_h, win_w, sw_h, sw_w):
    """Least time of one gather: the windows read once (prev window with
    its Scharr halo, superwindow), the outputs written once; ~40 f32
    operations per prev-window pixel (two smoothed columns and rows and
    two differences, each 3 products and 2 sums)."""
    read = n * ((win_h + 3) * (win_w + 3) + sw_h * sw_w) * 4
    written = n * (3 * (win_h + 1) * (win_w + 1) + sw_h * sw_w) * 4
    return bound(read + written, n * (win_h + 1) * (win_w + 1) * 40)


def serving_kernels(staging, card, reps=20):
    """Phase 12: the finish, the gather and the pair scan against their
    plain versions at the serving shapes; returns their report entries."""
    import torch
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.geometry import vanishing
    from lk_tpu_torch.ops import finish
    from lk_tpu_torch.pipeline import step

    def cmp(a, b):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
        return float((a - b).abs().max())

    # --- finish: a whole chunk (64 streams x 16 frames), and odd shapes:
    # H*W % 4 != 0, W % 4 != 0 (per-column loads), 2x2, more frames than a
    # grid dimension holds, f32 frames, a base not aligned for the vector
    # loads ---
    chunk = staging[1:1 + S_CHUNK].reshape(-1, SH, SW)
    rng = np.random.default_rng(12)
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 3 * 37 * 132).astype(
        np.uint8)).to(chunk.device)
    cases = [(chunk, f"{tuple(chunk.shape)} u8"),
             (staging[:3, 0, :37, :53].contiguous(), "(3, 37, 53) u8"),
             (torch.cat([staging[0, :1], staging[0, :1, :, :1]], -1),
              "(1, 483, 861) u8"),
             (staging[:2, 0, :2, :2].contiguous(), "(2, 2, 2) u8"),
             (torch.from_numpy(rng.integers(0, 256, (70000, 2, 4)).astype(
                 np.uint8)).to(chunk.device), "(70000, 2, 4) u8"),
             (chunk[:64].to(torch.float32), "(64, 483, 860) f32"),
             (flat[1:].view(3, 37, 132), "(3, 37, 132) u8 unaligned")]
    err_f = 0.0
    for x, label in cases:
        for contrast in (False, True):
            got = finish.fused_finish(x, contrast)
            want = finish.fused_finish_reference(x, contrast)
            e = cmp(got, want)
            same = torch.equal(got, want)
            print(f"[kernel] finish {label} contrast={contrast}: max|d| "
                  f"{e:.3g}, torch.equal {same}")
            check(same and got.shape == x.shape,
                  f"finish {label}: max|d| {e}")
            err_f = max(err_f, e)
    del cases, flat
    ms_f = cuda_ms(lambda: finish.fused_finish(chunk), reps)
    dms_f = device_us(lambda: finish.fused_finish(chunk),
                      {"finish_kernel": 1}) / 1e3
    pms_f = cuda_ms(lambda: finish.fused_finish_reference(chunk), 3)
    ms_ft = cuda_ms(lambda: finish.fused_finish(chunk, True), reps)
    px = chunk.numel()
    b_f, by_f = bound(px * (1 + 4), px * 10)
    xf = chunk.to(torch.float32)[:, None]
    conv = torch.nn.Conv2d(1, 1, 3, padding=1, padding_mode="reflect",
                           bias=False).to(chunk.device)
    g3 = torch.tensor([0.25, 0.5, 0.25], device=chunk.device)
    with torch.no_grad():
        conv.weight.copy_((g3[:, None] * g3[None, :])[None, None])
        lib_f = cuda_ms(lambda: conv(xf), reps)
        lib_err = float((conv(xf)[:, 0] - finish.fused_finish(chunk))
                        .abs().max())
    del xf
    print(f"[kernel] finish {tuple(chunk.shape)} u8 (one serving chunk): "
          f"kernel device {dms_f:.3f} ms (events {ms_f:.3f}, tone on "
          f"{ms_ft:.3f}), plain {pms_f:.3f} "
          f"ms, bound {b_f:.3f} ms ({by_f}; {b_f / dms_f:.1%} of it), "
          f"library nn.Conv2d reflect on the f32 frames {lib_f:.3f} ms "
          f"(max|d| {lib_err:.3g}); {FINISH_PARENT}  [{card}]")

    # --- gather: the tracker's calls of one frame step, and shuffled -------
    calls = record_calls(staging, sparse, "gather_windows", 1)
    err_g, ms_g, dms_g, pms_g, b_g, by_g = 0.0, [], [], [], [], set()
    perm_rng = np.random.default_rng(0)
    for i, args in enumerate(calls[-3:]):
        prev_f, next_f, cy, cx, sy, sx, wh, ww, swh, sww = args
        n = cy.shape[0]
        perm = torch.from_numpy(perm_rng.permutation(n)).to(cy.device)
        for label, c in (("frame-major", (cy, cx, sy, sx)),
                         ("shuffled", tuple(t[perm] for t in
                                            (cy, cx, sy, sx)))):
            ka = sparse.gather_windows(prev_f, next_f, *c, wh, ww, swh, sww)
            pa = sparse.gather_windows_reference(prev_f, next_f, *c, wh, ww,
                                                 swh, sww)
            e = max(cmp(ka[0], pa[0]), cmp(ka[1], pa[1]))
            check(e <= KERNEL_TOL, f"gather level {2 - i} {label}: {e}")
            err_g = max(err_g, e)
        a = (prev_f, next_f, cy, cx, sy, sx, wh, ww, swh, sww)
        ms_g.append(cuda_ms(lambda: sparse.gather_windows(*a), reps))
        dms_g.append(device_us(lambda: sparse.gather_windows(*a),
                               {"window_gather_kernel": 1}) / 1e3)
        pms_g.append(cuda_ms(lambda: sparse.gather_windows_reference(*a), 5))
        bm, bb = gather_bound(n, wh, ww, swh, sww)
        b_g.append(bm)
        by_g.add(bb)
        print(f"[kernel] window_gather level {2 - i}: folded "
              f"{tuple(prev_f.shape)}, {n} points, frame-major and "
              f"shuffled max|d| {err_g:.3g}; kernel device "
              f"{dms_g[-1] * 1e3:.1f} us (events {ms_g[-1]:.4f} ms), "
              f"plain {pms_g[-1]:.3f} ms, bound {bm:.4f} ms ({bb})  "
              f"[{card}]")
    del calls

    # --- the VP pair scan: the first chunk's steps, kernel == plain bit for
    # bit, one call a step ---
    def kept(state, cps, cand, *rest):
        return (type(state)(*(x.clone() for x in state)), cps.clone(),
                cand.clone(), *rest)

    calls = [kept(*args) for args in record_calls(
        staging, step, "process_frame_pairs", S_CHUNK)]
    check(len(calls) == S_CHUNK, f"{len(calls)} pair-scan calls recorded, "
          f"expected {S_CHUNK}")
    counts = []
    for state, cps, cand, cfg_s, size in calls:
        p = cand.shape[1]
        kept = [x.clone() for x in (*state, cps, cand)]
        want = vanishing.process_frame_pairs_reference(state, cps, cand,
                                                       cfg_s, size)
        got = vanishing.process_frame_pairs(state, cps, cand, cfg_s, size)
        torch.cuda.synchronize()
        same = all(same_bits(a, b) for a, b in
                   zip((*got[0], *got[1]), (*want[0], *want[1])))
        check(same, f"pair scan B={SB} P={p}: the kernel's bits differ from "
              f"the plain version's")
        check(all(same_bits(a, b)
                  for a, b in zip(kept, (*state, cps, cand))),
              "the pair scan wrote its inputs")
        counts.append((int(cand.sum(dim=1).max()), int(cand.sum()),
                       int(want[1].update_mask.sum())))
    state, cps, cand, cfg_s, size = calls[-1]
    p = cand.shape[1]
    new, out = vanishing.process_frame_pairs(state, cps, cand, cfg_s, size)

    def scan():
        vanishing.process_frame_pairs(state, cps, cand, cfg_s, size)

    ms_v = cuda_ms(scan, reps)
    dms_v = device_us(scan, {"vp_scan_kernel": 1}) / 1e3
    pms_v = cuda_ms(lambda: vanishing.process_frame_pairs_reference(
        state, cps, cand, cfg_s, size), 3)
    b_v, by_v = scan_bound(state, new, cps, cand, out)
    print(f"[kernel] vp_scan B={SB} P={p}, steps 1..{S_CHUNK} of the first "
          f"chunk (largest candidate count, candidates, updates): "
          f"{counts}; kernel == plain bit for bit, inputs unchanged; the last "
          f"step: kernel device {dms_v * 1e3:.1f} us (events "
          f"{ms_v * 1e3:.1f} us), plain op by op {pms_v:.3f} ms, bound "
          f"{b_v * 1e3:.3f} us ({by_v})  [{card}]")
    return [
        {"name": "finish", "route": "cuda",
         "source": "lk_tpu_torch/csrc/finish.cu",
         "replaces": "lk_tpu/ops/pallas_finish.py:114",
         "max_abs_err": err_f, "ms": dms_f, "event_ms": ms_f,
         "plain_ms": pms_f,
         "bound_ms": b_f, "bound_by": by_f, "library_ms": lib_f},
        {"name": "window_gather", "route": "cuda",
         "source": "lk_tpu_torch/csrc/window_gather.cu",
         "replaces": "lk_tpu/flow/pallas_kernels.py:2358",
         "max_abs_err": err_g, "ms": float(np.mean(dms_g)),
         "event_ms": float(np.mean(ms_g)),
         "plain_ms": float(np.mean(pms_g)),
         "bound_ms": float(np.mean(b_g)),
         "bound_by": "bytes" if by_g == {"bytes"} else "operations",
         "library_ms": None},
        {"name": "vp_scan", "route": "cuda",
         "source": "lk_tpu_torch/csrc/vp_scan.cu",
         "replaces": "lk_tpu/geometry/vanishing.py:213",
         "max_abs_err": 0.0, "ms": dms_v, "event_ms": ms_v,
         "plain_ms": pms_v, "bound_ms": b_v, "bound_by": by_v,
         "library_ms": None},
    ]


def serving_timing(staging, card, passes=2):
    """Phase 13: aggregate stream-frames/s of whole passes (feed_staged +
    drain), CUDA events, after phase 11's warm-up pass."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rates = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        serve_pass(staging)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        sf = SB * (SF - 1)
        rates.append(sf / ms * 1e3)
        print(f"[time] serving pass: {sf} stream-frames in {ms:.1f} ms = "
              f"{rates[-1]:.1f} stream-frames/s ({ms / (SF - 1):.2f} ms per "
              f"64-stream frame; host wall "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms)  [{card}]")
    return rates


STAGES = ("serve.finish", "tracker.fold", "tracker.gather", "tracker.refine",
          "step.detect", "step.vp_scan", "serve.compact", "serve.book",
          "serve.drain")
VIDEO_STAGES = ("video.wait", "video.ingest", "video.chunk",
                "tracker.pyramid", "tracker.scharr", "tracker.refine",
                "step.detect", "step.vp_scan", "video.drain")


def profile_stages(label, run, stages, frames, card):
    """Where one run's time goes, by the port's profiler ranges ``stages``
    (phases 14 and 17, --profile).  The ranges appear twice in the trace:
    as CPU ranges (host time inside each stage) and as annotations on the
    device timeline; each kernel counts for the stage whose device
    annotation holds its start.  Also the device's busy share: kernel time
    over the span from the first kernel's start to the last one's end."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    ann = sorted((e for e in dev_events if e.name in stages),
                 key=lambda e: e.time_range.start)
    kernels = [e for e in dev_events if e.name not in stages
               and not getattr(e, "is_user_annotation", False)]
    check(bool(kernels), "the profiler saw no device time")
    starts = [a.time_range.start for a in ann]
    dev = {}
    for k in kernels:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        st = (ann[i].name if i >= 0
              and k.time_range.start < ann[i].time_range.end else "other")
        n, us = dev.get(st, (0, 0.0))
        dev[st] = (n + 1, us + k.time_range.elapsed_us())
    host = {}
    for e in events:
        if e.name in stages and e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(us for _, us in dev.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    for st in stages + ("other",):
        n, us = dev.get(st, (0, 0.0))
        h = host.get(st)
        hs = ("" if h is None else
              f", host {h / 1e3 / frames:.2f} ms per frame "
              f"({h / 1e6 / wall:.1%} of the pass)")
        print(f"[profile] {label} {st}: device {us / 1e3 / frames:.3f} ms "
              f"per frame ({us / busy:.1%} of device time, "
              f"{n / frames:.0f} launches per frame){hs}  [{card}]")
    print(f"[profile] {label} pass under the profiler: wall {wall:.2f} s, "
          f"device busy {busy / 1e3:.1f} ms = {busy / span:.1%} of the "
          f"traced device span ({span / 1e3:.1f} ms), {len(kernels)} "
          f"kernel launches = {len(kernels) / frames:.0f} per frame  "
          f"[{card}]")


def profile_serving(staging, card):
    """Phase 14 (--profile): where a serving pass's time goes."""
    profile_stages("serving", lambda: serve_pass(staging), STAGES, SF - 1,
                   card)


# --------------------------------------------------------------------------
# the single-stream VP pipeline: VideoPipeline at the production geometry
# --------------------------------------------------------------------------

def video_frames(dev):
    """Phase 15's clip: one synthetic 1080p road scene expanding from a
    planted VP (``road_staging``'s stream 0), its gray copied into three
    BGR channels, as numpy u8 (V_FRAMES, 1080, 1920, 3); and the planted
    VP in processing coordinates (x 860/1920)."""
    staging, vps = road_staging(dev, n_streams=1, n_frames=V_FRAMES, h=H,
                                w=W)
    gray = staging[:, 0].cpu().numpy()
    return np.repeat(gray[..., None], 3, axis=-1), vps[0] * (SW / SRC[0])


def video_run(frames, prefetch=0, resume=None):
    """A fresh VideoPipeline (preset final, 1080p source, chunk 16) run
    over ``frames``, resumed from the checkpoint ``resume`` if given."""
    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline.runner import VideoPipeline

    p = VideoPipeline(PRESETS["final"], src_size=SRC, chunk=V_CHUNK)
    check((p.height, p.width) == (SH, SW),
          f"processing size {p.height}x{p.width}")
    if resume is not None:
        p.resume_from(resume)
    p.run(iter(frames), prefetch=prefetch)
    return p


def video_rows(p):
    """The run's outputs as arrays: csv rows, shown VP per frame (nan where
    hidden) and segments."""
    vpf = np.array([v if v is not None else (np.nan, np.nan)
                    for v in p.vp_per_frame], np.float64)
    segs = np.array([np.concatenate([s["start"], s["stop"]])
                     for s in p.segments], np.float32)
    return np.array(p.csv_rows, np.float64), vpf, segs


def same_rows(a, b) -> bool:
    return all(np.array_equal(x, y, equal_nan=True)
               for x, y in zip(video_rows(a), video_rows(b)))


def video_phases(frames, vp, card):
    """Phases 15 and 16: the counted single-stream run (prefetch 2, also
    the warm-up) and its checks; then whole runs timed with CUDA events
    (prefetch 0, prefetch 2, the plain pyramid with prefetch 0), each
    equal to the counted run; then a checkpointed split run.  Returns the
    counted run's launches."""
    import tempfile

    import torch

    from lk_tpu_torch.pipeline import runner

    tracked = V_FRAMES - 1
    reset_counters()
    run, wall = timed_call(video_run, frames, prefetch=2)
    launches, plain = kernel_counts()
    graphs = dict(runner.video_graph_counts)
    # prefetch 2: chunks of V_CHUNK frames, the first one's seeding
    stepped = single_stream_launches(-(-V_FRAMES // V_CHUNK), V_CHUNK - 1)
    print(f"[video] VideoPipeline final {SRC[0]}x{SRC[1]} -> {SW}x{SH}, "
          f"chunk {V_CHUNK}, prefetch 2, {V_FRAMES} frames: chunks {graphs}, "
          f"launches {launches} (one pyramid and pair scan per frame "
          f"stepped from the host: {stepped} of {tracked} tracked), plain "
          f"calls {plain}, first run {wall:.2f} s (incl. warm-up and the "
          f"capture)  [{card}]")
    check(plain == 0, f"plain versions ran {plain}x on the card")
    check(launches["pyr_down"] == launches["vp_scan"] == stepped,
          f"pyramid or pair-scan launches {launches}, expected {stepped}")
    check(launches["finish"] == launches["window_gather"] == 0,
          f"finish or gather launched: {launches}")
    check(run.frames_done == tracked and run.consumed_init_frame,
          f"{run.frames_done} frames done")
    rows, vpf, segs = video_rows(run)
    check(len(rows) > 10 and np.isfinite(rows).all(),
          f"{len(rows)} csv rows, finite {np.isfinite(rows).all()}")
    err = float(np.linalg.norm(rows[len(rows) // 2:].mean(0) - vp))
    print(f"[video] {len(rows)} csv rows, {len(segs)} segments, VP shown "
          f"on {int(np.isfinite(vpf[:, 0]).sum())} of {tracked} frames; "
          f"late-trajectory VP error vs planted {vp.round(2).tolist()}: "
          f"{err:.2f} px (limit {VP_ERR_LIMIT})")
    check(err < VP_ERR_LIMIT, f"VP error {err} px")

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for label, prefetch, plain in (("prefetch 0", 0, False),
                                   ("prefetch 2", 2, False),
                                   ("plain pyramid, prefetch 0", 0, True)):
        ctx = plain_tracker_pyramid() if plain else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            timed = video_run(frames, prefetch=prefetch)
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        print(f"[time] VideoPipeline {label}: {ms / tracked:.3f} ms per "
              f"tracked frame ({tracked} frames in {ms:.1f} ms; host wall "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms)  [{card}]")
        check(same_rows(run, timed), f"{label}: csv rows, shown VPs or "
              f"segments differ from the counted run")
    with tempfile.TemporaryDirectory() as tmp:
        first = video_run(frames[:V_SPLIT])
        ck = first.save_checkpoint(os.path.join(tmp, "ck.npz"))
        second = video_run(frames[V_SPLIT:], resume=ck)
    check(first.csv_rows + second.csv_rows == run.csv_rows
          and first.vp_per_frame + second.vp_per_frame == run.vp_per_frame,
          "the checkpointed split run differs from the uninterrupted one")
    print(f"[video] equal (np.array_equal) to the counted run: prefetch 0, "
          f"prefetch 2, the plain pyramid, and a split run checkpointed "
          f"after {(V_SPLIT - 1) // V_CHUNK} chunks and resumed in a fresh "
          f"VideoPipeline")
    return launches


def app_argv(*extra):
    return ["--synthetic", "--quiet", *map(str, extra)]


def vp_app_phase(card):
    """Phase 18: final, vp_detect and classify through their main(argv) on
    the card.  Returns (pyramid launches per app, seconds)."""
    import csv
    import importlib
    import tempfile

    from lk_tpu_torch.pipeline import runner

    t_phase = time.perf_counter()
    tracked = A_FRAMES - 1
    vp = np.array([A_SRC[0] * 0.5, A_SRC[1] * 0.45]) * (SW / A_SRC[0])
    launches = {}
    for app in ("final", "vp_detect", "classify"):
        module = importlib.import_module(f"lk_tpu_torch.apps.{app}")
        with tempfile.TemporaryDirectory() as tmp:
            argv = app_argv("--frames", A_FRAMES, "--out-dir", tmp)
            if app == "classify":
                argv += ["--motion-csv", os.path.join(tmp, "motion.csv")]
            reset_counters()
            pipe, dt = timed_call(module.main, argv)
            counts, plain = kernel_counts()
            graphs = dict(runner.video_graph_counts)
            stepped = single_stream_launches(-(-A_FRAMES // V_CHUNK),
                                             V_CHUNK - 1)
            with open(os.path.join(tmp, "vps_synthetic.csv")) as f:
                rows = list(csv.reader(f))
            if app == "classify":
                with open(os.path.join(tmp, "motion.csv")) as f:
                    motion = list(csv.reader(f))
        check(plain == 0, f"{app}: plain versions ran {plain}x")
        check(counts == {"pyr_down": stepped, "finish": 0,
                         "window_gather": 0, "vp_scan": stepped},
              f"{app}: launches {counts}, expected {stepped} pyramids "
              f"and pair scans")
        check(pipe.frames_done == tracked, f"{app}: {pipe.frames_done} "
              f"frames done")
        check(rows[0] == ["x", "y"] and len(rows) - 1 == len(pipe.csv_rows)
              and all(len(r) == 2 for r in rows[1:]),
              f"{app}: malformed vps_synthetic.csv")
        got = np.array(rows[1:], np.float64)
        check(np.array_equal(got, np.array(pipe.csv_rows, np.float64)
                             .reshape(-1, 2)) and np.isfinite(got).all(),
              f"{app}: the csv file differs from the run's rows")
        check(len(got) > 0, f"{app}: no csv row")
        err = float(np.linalg.norm(got[len(got) // 2:].mean(0) - vp))
        check(err < VP_ERR_LIMIT, f"{app}: VP error {err} px")
        if app == "classify":
            check(motion[0] == ["static", "away", "toward", "lateral"]
                  and len(motion) - 1 == tracked,
                  f"classify: motion csv has {len(motion) - 1} rows")
        with tempfile.TemporaryDirectory() as tmp, plain_tracker_pyramid():
            ref = module.main(app_argv("--frames", A_FRAMES, "--out-dir",
                                       tmp))
        check(same_rows(pipe, ref), f"{app}: rows, shown VPs or segments "
              f"differ with the plain pyramid")
        launches[app] = counts["pyr_down"]
        print(f"[apps] {app} --synthetic {A_SRC[0]}x{A_SRC[1]} -> "
              f"{pipe.width}x{pipe.height}, {A_FRAMES} frames: chunks "
              f"{graphs}, launches {counts} (from the host: {stepped} "
              f"frames of {tracked} stepped), plain calls {plain}; "
              f"{len(got)} csv rows (file "
              f"well formed), {len(pipe.segments)} segments, late-trajectory "
              f"VP error {err:.2f} px (limit {VP_ERR_LIMIT})"
              + (f", {len(motion) - 1} motion rows" if app == "classify"
                 else "")
              + f"; rows == the plain-pyramid run; {dt * 1e3 / tracked:.2f} "
              f"ms per tracked frame = {tracked / dt:.1f} frames/s (main, "
              f"host clock, incl. rendering the source)  [{card}]")
    wall = time.perf_counter() - t_phase
    print(f"[apps] phase 18 wall {wall:.1f} s")
    return launches, wall


def tracker_app_phase(card):
    """Phase 19: masking and roadlines' compute parts on the card."""
    import importlib

    import torch
    from lk_tpu_torch.apps import _common
    from lk_tpu_torch.geometry.hough import hough_road_lines

    t_phase = time.perf_counter()
    tracked = T_FRAMES - 1
    launches = {}
    for app in ("masking", "roadlines"):
        module = importlib.import_module(f"lk_tpu_torch.apps.{app}")
        parser = _common.build_parser(app)
        if app == "roadlines":
            module.add_args(parser)
        args = parser.parse_args(app_argv("--frames", T_FRAMES))
        reset_counters()
        res, dt = timed_call(module.compute, args)
        counts, plain = kernel_counts()
        check(plain == 0, f"{app}: plain versions ran {plain}x")
        check(counts == {"pyr_down": tracked, "finish": 0,
                         "window_gather": 0, "vp_scan": 0},
              f"{app}: launches {counts}, expected {tracked} pyramids")
        check(res.frames == T_FRAMES and res.width == 960,
              f"{app}: {res.frames} frames at width {res.width}")
        with plain_tracker_pyramid():
            ref = module.compute(args)
        extra = ""
        if app == "masking":
            n = len(res.segments)
            check(n > 0, "masking: no segment")
            check(res.segments == ref.segments,
                  "masking: segments differ with the plain pyramid")
        else:
            n = len(res.lengths)
            check(n > 0 and res.hough is not None, "roadlines: no segment")
            check(res.lengths == ref.lengths and res.angles == ref.angles
                  and np.array_equal(res.start, ref.start)
                  and np.array_equal(res.stop, ref.stop),
                  "roadlines: segments differ with the plain pyramid")
            moving = torch.from_numpy((res.start != res.stop).any(axis=1))
            cpu = hough_road_lines(torch.from_numpy(res.start),
                                   torch.from_numpy(res.stop), moving,
                                   (res.width, res.height), k=args.hough_k)
            h = res.hough
            d_t = float((h.theta.cpu() - cpu.theta).abs().max())
            d_r = float((h.rho.cpu() - cpu.rho).abs().max())
            d_acc = float((h.accumulator.cpu() - cpu.accumulator).abs().max()
                          / cpu.accumulator.abs().max())
            check(d_t <= 1e-4 and d_r <= 1e-2,
                  f"roadlines: Hough on the card vs the CPU: theta "
                  f"{d_t} rad, rho {d_r} px")
            lines = ", ".join(f"({np.degrees(t):.1f} deg, {r:.1f} px, "
                              f"{v:.0f})" for t, r, v in zip(
                                  h.theta.tolist(), h.rho.tolist(),
                                  h.votes.tolist()))
            extra = (f"; Hough on the card vs the CPU: max |dtheta| "
                     f"{d_t:.3g} rad (limit 1e-4), max |drho| {d_r:.3g} px "
                     f"(limit 1e-2), accumulator {d_acc:.3g} of its max; "
                     f"lines {lines}")
        launches[app] = counts["pyr_down"]
        print(f"[apps] {app}.compute --synthetic {A_SRC[0]}x{A_SRC[1]} -> "
              f"{res.width}x{res.height}, {T_FRAMES} frames: launches "
              f"{counts}, plain calls {plain}, {n} segments == the plain-"
              f"pyramid run{extra}; {dt * 1e3 / tracked:.2f} ms per tracked "
              f"frame = {tracked / dt:.1f} frames/s  [{card}]")
    wall = time.perf_counter() - t_phase
    print(f"[apps] phase 19 wall {wall:.1f} s")
    return launches, wall


def serve_app_phase(card):
    """Phase 20: serve.run_server at its defaults, then with
    --async-drains, counted; rows against the plain versions."""
    from lk_tpu_torch.apps import serve

    t_phase = time.perf_counter()
    parser = serve.build_parser()
    runs = {}
    launches = None
    for label, flags in (("sync", []), ("async", ["--async-drains"])):
        args = parser.parse_args(["--quiet", *flags])
        reset_counters()
        run, dt = timed_call(serve.run_server, args)
        counts, plain = kernel_counts()
        frames = args.frames - 1
        want = serving_launches(-(-frames // args.chunk), args.chunk,
                                passes=2)
        ms = run.server
        check(plain == 0, f"serve {label}: plain versions ran {plain}x")
        check(counts == want, f"serve {label}: launches {counts} over the "
              f"warm-up and timed passes, expected {want}")
        check((ms.width, ms.height) == (SW, SH)
              and all(p.frames_done == frames for p in ms.pipes),
              f"serve {label}: {ms.width}x{ms.height}, frames done "
              f"{[p.frames_done for p in ms.pipes]}")
        with_vp = sum(1 for p in ms.pipes if len(p.csv_rows))
        check(with_vp == args.streams,
              f"serve {label}: {with_vp}/{args.streams} streams with VP "
              f"output")
        vps = np.array([(args.width * (0.45 + 0.01 * (s % 5)),
                         args.height * 0.45)
                        for s in range(args.streams)]) * (SW / args.width)
        errs = vp_errors(ms, vps)
        check(float(np.mean(errs)) < VP_ERR_LIMIT,
              f"serve {label}: mean VP error {np.mean(errs)} px")
        runs[label] = run
        launches = counts
        print(f"[apps] serve {label}: {args.streams} streams x "
              f"{args.frames} frames {args.width}x{args.height} -> "
              f"{ms.width}x{ms.height}, chunk {args.chunk}: launches "
              f"{counts} (warm-up + timed pass), plain calls {plain}, "
              f"{with_vp}/{args.streams} streams with VP output, mean VP "
              f"error {np.mean(errs):.2f} px; timed pass "
              f"{run.agg:.1f} frames/s aggregate "
              f"({run.wall_s * 1e3 / frames:.2f} ms per "
              f"{args.streams}-stream frame; run_server wall "
              f"{dt:.1f} s incl. staging and warm-up)  [{card}]")
    for a, b in zip(runs["sync"].server.pipes, runs["async"].server.pipes):
        check(a.csv_rows == b.csv_rows and a.vp_per_frame == b.vp_per_frame,
              "serve: --async-drains rows differ from the sync run")
    args = parser.parse_args(["--quiet", "--streams", "4"])
    with plain_versions():
        ref = serve.run_server(args)
    worst = 0.0
    for b in range(4):
        x = np.array(runs["sync"].server.pipes[b].csv_rows,
                     np.float64).reshape(-1, 2)
        y = np.array(ref.server.pipes[b].csv_rows, np.float64).reshape(-1, 2)
        check(x.shape == y.shape, f"serve stream {b}: {len(x)} csv rows vs "
              f"{len(y)} through the plain versions")
        worst = max(worst, float(np.abs(x - y).max(initial=0.0)))
    check(worst <= ROWS_TOL, f"serve: rows differ by {worst} px")
    wall = time.perf_counter() - t_phase
    print(f"[apps] serve: --async-drains rows == the sync run's; streams "
          f"0-3 through the plain versions: same counts, max |drow| "
          f"{worst:.3g} px (tolerance {ROWS_TOL}); aggregate "
          f"{runs['sync'].agg:.1f} (sync) / {runs['async'].agg:.1f} (async) "
          f"frames/s  [{card}]")
    print(f"[apps] phase 20 wall {wall:.1f} s")
    return launches, wall


# --------------------------------------------------------------------------
# phases 21-24: the parallel layer (lk_tpu_torch.parallel) on the one card
# --------------------------------------------------------------------------

P_DISP = 8                 # the spatial level's displacement bound
RANK_TIMEOUT = 300         # s for each rank process of phase 24
P_WORLD = 2                # ranks sharing the card in phase 24 (gloo)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spatial_pair(dev):
    """The parallel phases' 1080p pair: a textured canvas moved (3.7, -2.2)
    px, the same numbers in every process (seed 21)."""
    import torch

    frames = affine_video(np.random.default_rng(21), H, W, 2,
                          translation(3.7, -2.2))
    return torch.from_numpy(frames).to(dev)


def spatial_modes():
    """(name, exchange_per_iter, DenseLKConfig) of the spatial phases."""
    from lk_tpu_torch.config import DenseLKConfig

    return [(f"{'per-iteration' if per else 'single'} exchange, "
             f"{'fused kernel' if fused else 'XLA level'}", per,
             DenseLKConfig(use_pallas_fused=fused))
            for fused in (False, True) for per in (False, True)]


def rank_programs(prev, nxt, flow, shards, cfg, dcfg, per_iter):
    """The sharded spatial level's rank programs run one after the other in
    this process: each rank's row block padded as halo_exchange pads it
    (neighbour rows, the frame's edge row replicated beyond it), the level
    run on it, the block's own rows kept; per iteration, the flow
    re-padded each round with the eps mask carried across rounds (XLA
    level) as lk_tpu/parallel/spatial.py does."""
    import dataclasses

    import torch
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel.spatial import (iteration_halo,
                                               single_exchange_halo)

    n = prev.shape[0]
    per = n // shards

    def level(f, halo, d):
        out = []
        for i in range(shards):
            rows = torch.arange(i * per - halo, (i + 1) * per + halo,
                                device=prev.device).clamp(0, n - 1)
            out.append(dense.dense_lk_level(
                prev[rows], nxt[rows], f[rows], cfg, d,
                max_disp=P_DISP).flow[halo:halo + per])
        return torch.cat(out)

    if not per_iter:
        return level(flow, single_exchange_halo(cfg, dcfg, P_DISP), dcfg)
    one = dataclasses.replace(dcfg, outer_iters=1, iter_schedule=())
    f = flow
    active = torch.ones(f.shape[:2], dtype=torch.bool, device=f.device)
    for _ in range(dcfg.outer_iters):
        f_new = level(f, iteration_halo(cfg, P_DISP), one)
        if dcfg.use_pallas_fused:
            f = f_new
            continue
        d = f_new - f
        f = torch.where(active[..., None], f_new, f)
        active = active & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                           > cfg.eps * cfg.eps)
    return f


def sink_arrays(p) -> dict:
    """One sink's outputs as arrays: csv rows, the shown VP per frame (NaN
    where none), cross points, accepted segments."""
    nan = (float("nan"),) * 2
    return {
        "csv": np.array(p.csv_rows, np.float64).reshape(-1, 2),
        "shown": np.array([v if v is not None else nan
                           for v in p.vp_per_frame], np.float64),
        "cps": np.array(p.cross_points, np.float64).reshape(-1, 2),
        "segs": np.array([np.concatenate([s["start"], s["stop"]])
                          for s in p.segments], np.float64).reshape(-1, 4),
    }


def same_sinks(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def sharded_serving_phase(staging, ref_rows, unsharded_rates, card):
    """Phase 21: MultiStreamPipeline(mesh=...) at world size 1 under NCCL,
    the cell of phase 13 (64 streams x 64 frames, 860x483, preset final,
    chunk 16): counted (the finish, the gather and the pyramid, as phase
    11), every stream's rows equal (np.array_equal) to phase 11's
    unsharded run, then a timed pass beside phase 13's."""
    import torch
    from lk_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1,), ("streams",))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ms = serve_pass(staging, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = kernel_counts()
    want = serving_launches(n_chunks())
    frames = SF - 1
    check(plain == 0, f"plain versions ran {plain}x")
    check(launches == want,
          f"sharded serving launches {launches}, expected {want}")
    check(ms.streams == slice(0, SB) and len(ms.pipes) == SB,
          f"world 1 holds streams {ms.streams}")
    equal = all(same_sinks(sink_arrays(p), r)
                for p, r in zip(ms.pipes, ref_rows))
    check(equal, "sharded serving rows differ from the unsharded run")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    serve_pass(staging, mesh=mesh)
    end.record()
    torch.cuda.synchronize()
    ev = start.elapsed_time(end)
    rate = SB * frames / ev * 1e3
    print(f"[parallel] 21 world 1 (NCCL) MultiStreamPipeline(mesh) B={SB} "
          f"{SW}x{SH} chunk {S_CHUNK}: launches {launches}, plain calls 0, "
          f"rows of all {SB} streams == the unsharded run (np.array_equal); "
          f"timed pass {ev:.1f} ms = {rate:.1f} stream-frames/s vs phase "
          f"13's unsharded {max(unsharded_rates):.1f} (best of "
          f"{len(unsharded_rates)}); counted pass wall {wall:.1f} s  "
          f"[{card}]")
    return launches, rate


def spatial_phase(prev, nxt, card):
    """Phase 22: spatial_dense_lk_level at world size 1 under NCCL at
    1080p, both exchange modes, XLA level and fused kernel: equal
    (torch.equal) to the rank program run in one process; the single
    exchange's XLA level equal to the unsharded level outside the
    replicated-edge belt; device time beside the unsharded level's."""
    import torch
    from lk_tpu_torch.config import LKConfig
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel import make_mesh, spatial_dense_lk_level
    from lk_tpu_torch.parallel.spatial import single_exchange_halo

    cfg = LKConfig()
    mesh = make_mesh((1, 1))
    zero = torch.zeros((H, W, 2), dtype=torch.float32, device=prev.device)
    launches = {}
    for name, per, dcfg in spatial_modes():
        fn = spatial_dense_lk_level(mesh, cfg, dcfg, max_disp=P_DISP,
                                    exchange_per_iter=per)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        got = fn(prev, nxt, zero)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, plain = dense_counts()
        check(plain == 0, f"{name}: plain versions ran {plain}x")
        fused = {k: v for k, v in counts.items() if v}
        if dcfg.use_pallas_fused:
            check(fused == {"tiled": dcfg.outer_iters},
                  f"{name}: launches {fused}")
            launches[f"spatial, {name}"] = fused
        check(torch.equal(got, rank_programs(prev, nxt, zero, 1, cfg, dcfg,
                                              per)),
              f"{name}: differs from its rank program")
        whole = dense.dense_lk_level(prev, nxt, zero, cfg, dcfg,
                                     max_disp=P_DISP).flow
        # the replicated edge rows reach the halo, then win//2 rows per
        # further iteration
        belt = single_exchange_halo(cfg, dcfg, P_DISP)
        dev_in = float((got - whole)[belt:-belt].abs().max())
        if not per and not dcfg.use_pallas_fused:
            check(dev_in == 0.0, f"{name}: interior differs from the "
                  f"unsharded level by {dev_in} px")
        s_ms = cuda_ms(lambda: fn(prev, nxt, zero), 3)
        u_ms = cuda_ms(lambda: dense.dense_lk_level(
            prev, nxt, zero, cfg, dcfg, max_disp=P_DISP), 3)
        print(f"[parallel] 22 world 1 (NCCL) spatial_dense_lk_level "
              f"{H}x{W}, {name}, {dcfg.outer_iters} iterations, disp "
              f"{P_DISP}: == its rank program (torch.equal); max |dflow| vs "
              f"the unsharded level outside the {belt}-row edge belt "
              f"{dev_in:.3g} px; launches {fused or 'none'}; "
              f"{s_ms:.3f} ms vs unsharded {u_ms:.3f} ms (CUDA events); "
              f"first call wall {wall:.2f} s  [{card}]")
    return launches


def pyramidal_phase(prev, nxt, card):
    """Phase 23: sharded_dense_pyramidal_lk at world size 1 under NCCL at
    1080p (default config: the XLA level, the pyramid kernel): equal
    (torch.equal) at every pixel to the unsharded dense_pyramidal_lk."""
    import torch
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.parallel import make_mesh, sharded_dense_pyramidal_lk

    run = sharded_dense_pyramidal_lk(make_mesh((1, 1)))
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    got = run(prev, nxt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dense_counts()
    check(plain == 0, f"plain versions ran {plain}x")
    launches = {k: v for k, v in counts.items() if v}
    check(set(launches) == {"pyr_down"}, f"launches {launches}")
    ref = dense.dense_pyramidal_lk(prev, nxt).flow
    check(torch.equal(got, ref), "sharded pyramidal flow differs from the "
          "unsharded solve")
    s_ms = cuda_ms(lambda: run(prev, nxt), 3)
    u_ms = cuda_ms(lambda: dense.dense_pyramidal_lk(prev, nxt), 3)
    print(f"[parallel] 23 world 1 (NCCL) sharded_dense_pyramidal_lk {H}x{W}: "
          f"== dense_pyramidal_lk at every pixel (torch.equal); launches "
          f"{launches}; {s_ms:.3f} ms vs unsharded {u_ms:.3f} ms (CUDA "
          f"events); first call wall {wall:.2f} s  [{card}]")
    return launches


def rank_command(rank: int, port: int, out: str) -> list:
    """The command line of one rank of phase 24: this script in rank mode."""
    return [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
            "--world", str(P_WORLD), "--port", str(port), "--out", out]


def world2_phase(prev, nxt, ref_rows, card):
    """Phase 24: two ranks on the one card under gloo (NCCL takes one rank
    per GPU), halos staged through host memory: the spatial level under
    use_pallas_fused at 1080p, both modes, equal (np.array_equal) to the
    two rank programs run here, each mode launching the tiled fused level
    once per iteration on each rank; sharded serving at 64 streams, 32 per rank, each
    stream's rows equal to phase 11's unsharded run."""
    import tempfile

    import torch
    from lk_tpu_torch.config import DenseLKConfig, LKConfig

    cfg = LKConfig()
    port = free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            rank_command(r, port, out), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(P_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0,
                  f"world-2 rank {r} failed (rc {p.returncode}):\n"
                  f"{log[-3000:]}")
        ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                 for r in range(P_WORLD)]
        info = [json.loads(open(os.path.join(out, f"rank{r}.json")).read())
                for r in range(P_WORLD)]
    wall = time.perf_counter() - t0
    zero = torch.zeros((H, W, 2), dtype=torch.float32, device=prev.device)
    for name, per, dcfg in spatial_modes():
        if not dcfg.use_pallas_fused:
            continue
        key = f"spatial_{int(per)}"
        got = np.concatenate([r[key] for r in ranks])
        want = rank_programs(prev, nxt, zero, P_WORLD, cfg, dcfg,
                             per).cpu().numpy()
        err = float(np.abs(got - want).max())
        check(np.array_equal(got, want),
              f"world 2, {name}: max |dflow| {err} px vs its rank programs")
        for r, i in enumerate(info):
            check(i["spatial_launches"][key] == {"tiled": dcfg.outer_iters},
                  f"world 2, {name}: rank {r} launches "
                  f"{i['spatial_launches'][key]}")
        print(f"[parallel] 24 world 2 (gloo, halos through the host) "
              f"spatial_dense_lk_level {H}x{W}, {name}: == the two rank "
              f"programs run here (np.array_equal); launches per rank "
              f"{info[0]['spatial_launches'][key]}; rank walls "
              f"{[i['walls'][key] for i in info]} s  [{card}]")
    streams = []
    for r in range(P_WORLD):
        lo, hi = info[r]["streams"]
        check((lo, hi) == (r * SB // P_WORLD, (r + 1) * SB // P_WORLD),
              f"rank {r} holds streams {lo}:{hi}")
        for b in range(lo, hi):
            streams.append({k: ranks[r][f"s{b}_{k}"] for k in ref_rows[b]})
    check(len(streams) == SB, f"{len(streams)} streams came back")
    check(all(same_sinks(a, b) for a, b in zip(streams, ref_rows)),
          "world-2 serving rows differ from the unsharded run")
    frames = SF - 1
    for r, i in enumerate(info):
        c = i["serve_launches"]
        want = serving_launches(n_chunks(), graphs=i["serve_graphs"])
        check(c == want, f"rank {r} serving launches {c}, expected {want}")
        check(i["plain"] == 0, f"rank {r}: plain versions ran")
    rates = [SB // P_WORLD * frames / i["walls"]["serving"] for i in info]
    print(f"[parallel] 24 world 2 serving B={SB} ({SB // P_WORLD} per rank) "
          f"{SW}x{SH}: rows of all {SB} streams == the unsharded run "
          f"(np.array_equal); launches per rank {info[0]['serve_launches']}; "
          f"per-rank pass walls {[i['walls']['serving'] for i in info]} s "
          f"({[round(x, 1) for x in rates]} stream-frames/s each, the two "
          f"ranks sharing the card); phase wall {wall:.1f} s  [{card}]")
    return [{k: v for k, v in i.items() if k.endswith("launches")}
            for i in info]


def parallel_rank(argv) -> int:
    """One rank of phase 24 (``--rank r --world n --port p --out dir``):
    gloo on cuda:0; writes its flow rows and sink arrays to
    dir/rank<r>.npz and its launches and walls to dir/rank<r>.json."""
    import argparse

    ap = argparse.ArgumentParser()
    for a in ("--rank", "--world", "--port"):
        ap.add_argument(a, type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as dist
    from lk_tpu_torch.config import LKConfig
    from lk_tpu_torch.parallel import make_mesh, spatial_dense_lk_level
    from lk_tpu_torch.parallel.mesh import local_rows
    from lk_tpu_torch.parallel.multihost import init_multihost
    from lk_tpu_torch.pipeline import runner

    init_multihost(f"localhost:{args.port}", args.world, args.rank,
                   backend="gloo")
    dev = device()
    res, walls, spatial_launches = {}, {}, {}
    try:
        prev, nxt = spatial_pair(dev)
        rows = make_mesh((1, args.world))
        mine = local_rows(rows, H, "spatial")
        zero = torch.zeros((mine.stop - mine.start, W, 2),
                           dtype=torch.float32, device=dev)
        for _, per, dcfg in spatial_modes():
            if not dcfg.use_pallas_fused:
                continue
            fn = spatial_dense_lk_level(rows, LKConfig(), dcfg,
                                        max_disp=P_DISP,
                                        exchange_per_iter=per)
            key = f"spatial_{int(per)}"
            reset_counters()
            got, sec = timed_call(fn, prev[mine], nxt[mine], zero)
            counts, _ = dense_counts()
            spatial_launches[key] = {k: v for k, v in counts.items() if v}
            res[key] = got.cpu().numpy()
            walls[key] = round(sec, 3)
        streams = make_mesh((args.world,), ("streams",))
        own = local_rows(streams, SB, "streams")
        staging, _ = road_staging(dev, n_streams=own.stop - own.start,
                                  first=own.start)
        serve_pass(staging, mesh=streams)            # warm-up
        reset_counters()
        ms, sec = timed_call(serve_pass, staging, mesh=streams)
        walls["serving"] = round(sec, 3)
        serve_launches, plain = kernel_counts()
        serve_graphs = dict(runner.chunk_graph_counts)
        for b, p in zip(range(own.start, own.stop), ms.pipes):
            for k, v in sink_arrays(p).items():
                res[f"s{b}_{k}"] = v
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **res)
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as fh:
            json.dump({"streams": [ms.streams.start, ms.streams.stop],
                       "walls": walls, "plain": plain,
                       "serve_launches": serve_launches,
                       "serve_graphs": serve_graphs,
                       "spatial_launches": spatial_launches},
                      fh)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    if "--rank" in sys.argv[1:]:             # a rank of phase 24
        return parallel_rank(sys.argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lk_tpu_torch import _build
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import lk_kernels as lk
    from lk_tpu_torch.ops import blur

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device()

    # --- 0. environment ------------------------------------------------------
    card = card_line()
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[env] nvcc: {sh([_build._nvcc(), '--version']).splitlines()[-1]}")

    # --- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    nvcc = ("cached" if _build.build_seconds is None
            else f"nvcc {_build.build_seconds:.1f} s")
    print(f"[build] {', '.join(_build.SOURCES)}: "
          f"{time.perf_counter() - t0:.1f} s ({nvcc}) -> {_build.build_dir()}")
    for line in _build.build_log.splitlines():
        if ("Function properties" in line or "registers" in line
                or "spill" in line or "smem" in line):
            print(f"[build] {line.strip()}")

    cfg, dcfg = configs()
    hw = (H, W)
    ecfg = dense._effective_cfg(cfg, dcfg, hw)
    plan = dense._video_level_plan(
        ecfg, dcfg, dense.pyramid_base_geometry(H, W, ecfg, dcfg), true_hw=hw)
    check(plan is not None, "no video plan at 1080p")
    for p in plan:
        print(f"[plan] {p}")

    rng = np.random.default_rng(1234)
    t0 = time.perf_counter()
    shift = translation(3.7, -2.2)
    zoom = zoom_rotation(H, W, 1.004, 0.3)
    scenes = [("translation (3.7, -2.2)", shift,
               affine_video(rng, H, W, FRAMES, shift)),
              ("zoom 1.004 + rotation 0.3 deg", zoom,
               affine_video(rng, H, W, FRAMES, zoom))]
    print(f"[data] 2 scenes x {FRAMES} frames {H}x{W}: "
          f"{time.perf_counter() - t0:.1f} s (host, set-up)")

    # --- 2. kernel vs plain at the 1080p plan shapes -------------------------
    frames0 = torch.from_numpy(scenes[0][2]).to(dev)
    stacks = dense.build_frame_levels(frames0[:K + 1], cfg, dcfg)
    per_variant, rows = compare_levels(stacks, plan, cfg, timing_reps=20)
    for (k, name, var, err, eig, flips, equal, dms, ms, pms, b_ms, b_by,
         shape_us) in rows:
        shapes = ", ".join(f"{bh}x{bw} {us:.1f} us" for (bh, bw), us
                           in zip(lk.BLOCK_SHAPES, shape_us))
        print(f"[kernel] K={k} {name} ({var}): max|dflow| {err:.3g} px, "
              f"max rel dmin_eig {eig:.3g}, valid flips {flips:.3g}, "
              f"bit-equal {equal}; kernel device {dms:.4f} ms "
              f"({dms / k:.4f} ms/pair; events {ms:.4f} ms), bound "
              f"{b_ms:.4f} ms ({b_by}), plain {pms:.3f} ms; each block "
              f"shape forced (same bits): {shapes}  [{card}]")
    for var, v in per_variant.items():
        print(f"[kernel] fused_lk_level[{var}] at the 1080p plan shapes: "
              f"device {v['ms']:.4f} ms (first design: "
              f"{FIRST_DESIGN_MS[var]} ms), bound "
              f"{v['bound_ms']:.4f} ms, max|dflow| {v['max_abs_err']:.3g} px"
              f"  [{card}]")
    print(f"[kernel] chunk (K={K}) output == single-pair output: "
          "bit-identical")
    spill_check(frames0, card)

    # --- 3. main path --------------------------------------------------------
    launches = None
    video_pair0 = {}
    for label, a, frames_np in scenes:
        frames = torch.from_numpy(frames_np).to(dev)
        torch.cuda.synchronize()
        reset_counters()
        out = dense.dense_pyramidal_lk_video(frames, cfg, dcfg)
        torch.cuda.synchronize()
        counts = dict(lk.kernel_launches_by_variant)
        plain = lk.plain_calls + blur.plain_calls
        check(plain == 0, f"plain versions ran {plain}x")
        check(all(n > 0 for n in counts.values()),
              f"a kernel variant never launched: {counts}")
        check(blur.kernel_launches == VIDEO_PYRAMIDS,
              f"pyramid launches {blur.kernel_launches} != one per build "
              f"({VIDEO_PYRAMIDS})")
        counts["pyr_down"] = blur.kernel_launches
        with plain_pyramid():
            ref = dense.dense_pyramidal_lk_video(frames, cfg, dcfg)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, ref)),
              f"{label}: the video's flow, min_eig or valid differ with the "
              f"plain pyramid")
        del ref
        if launches is None:
            launches = counts
        video_pair0[label] = out.flow[0].clone()
        flow = out.flow.cpu().numpy()
        check(flow.shape == (FRAMES - 1, H, W, 2), f"flow {flow.shape}")
        check(bool(np.isfinite(flow).all()), "non-finite flow")
        check(tuple(out.min_eig.shape) == (FRAMES - 1, H, W)
              and out.valid.dtype == torch.bool, "stats shape/dtype")
        epe = mean_epe(flow, a)
        print(f"[main] {label}: {FRAMES} frames -> flow {flow.shape}, "
              f"launches {counts}, plain calls {plain}, flow, min_eig and "
              f"valid == the run with the plain pyramid, "
              f"valid {float(out.valid.float().mean()):.4f}, mean EPE vs "
              f"ground truth {epe:.4f} px (limit {EPE_LIMIT})")
        check(epe < EPE_LIMIT, f"{label}: EPE {epe} >= {EPE_LIMIT}")
    del out, frames

    # --- 4. timing: the chained 1080p video, kernel vs plain -----------------
    frames = frames0

    def run_video():
        dense.dense_pyramidal_lk_video(frames, cfg, dcfg)

    def run_video_plain():
        # dense.py looks its kernels' wrappers up at call time: point them
        # at the plain versions for this run only
        dense.fused_lk_level = lk.fused_lk_level_reference
        try:
            with plain_pyramid():
                run_video()
        finally:
            dense.fused_lk_level = lk.fused_lk_level

    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(cuda_ms(
            run_video_plain if which == "plain" else run_video,
            1 if which == "plain" else 3))
    kms, pms = min(times["kernel"]), min(times["plain"])
    pairs = FRAMES - 1
    print(f"[time] dense_pyramidal_lk_video {FRAMES}x{H}x{W} ({pairs} pairs, "
          f"chunk {K}): kernel {kms:.2f} ms = {pairs / kms * 1e3:.1f} "
          f"pairs/s; plain {pms:.2f} ms = {pairs / pms * 1e3:.1f} pairs/s"
          f" (one pair = one output flow field)  [{card}]")
    if profile:
        profile_run("video", run_video, card)
    del frames

    # --- 6. per-pair kernels vs plain at the paths' shapes -------------------
    pyr_kernel = pyramid_phase(frames0, cfg, card)
    p_kernels = perpair_kernels(frames0, cfg, card)

    # --- 7-8. paths A (entry()), B and C, counted ----------------------------
    p_launches = perpair_paths(scenes, video_pair0, cfg, card)

    # --- 9. per-pair timing --------------------------------------------------
    perpair_timing(frames0, cfg, card, profile)

    # --- 25. the functions the port added last (here: the video's frames
    # are still on the card) ----------------------------------------------
    t0 = time.perf_counter()
    surface_phase(frames0, cfg, dcfg, card)
    print(f"[surface] phase 25 wall {time.perf_counter() - t0:.1f} s")
    del frames0, scenes, video_pair0

    # --- 10. serving scenes --------------------------------------------------
    t0 = time.perf_counter()
    staging, vps = road_staging(dev)
    torch.cuda.synchronize()
    print(f"[data] serving staging {tuple(staging.shape)} u8: "
          f"{time.perf_counter() - t0:.1f} s (set-up)")

    # --- 11. serving main path -----------------------------------------------
    s_launches, s_ms = serving_main_path(staging, vps, card)
    ref_rows = [sink_arrays(p) for p in s_ms.pipes]
    del s_ms

    # --- 12. serving kernels vs plain at serving shapes ----------------------
    s_kernels = serving_kernels(staging, card)

    # --- 13. serving timing --------------------------------------------------
    rates = serving_timing(staging, card)
    print(f"[time] serving B={SB} {SW}x{SH}: aggregate "
          f"{max(rates):.1f} stream-frames/s (best of {len(rates)} passes; "
          f"{max(rates) / 30:.1f} x 30 fps streams)  [{card}]")
    if profile:
        profile_serving(staging, card)
    del staging

    # --- 15. single-stream VP pipeline, counted, and its checks --------------
    t0 = time.perf_counter()
    v_frames, v_vp = video_frames(dev)
    print(f"[data] single-stream clip {v_frames.shape} u8 BGR: "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    # --- 16. single-stream timing (inside video_phases) ----------------------
    v_launches = video_phases(v_frames, v_vp, card)
    if profile:
        # --- 17. where a single-stream run's time goes -----------------------
        profile_stages("video", lambda: video_run(v_frames), VIDEO_STAGES,
                       V_FRAMES - 1, card)
        # last: once the anatomy copies' CUDA modules are loaded, the
        # profiler loses launches of later traces (seen on the card)
        level_anatomy(stacks, plan, cfg, card)
    del stacks, v_frames

    # --- 18-20. the apps -----------------------------------------------------
    app_launches, w18 = vp_app_phase(card)
    t_launches, w19 = tracker_app_phase(card)
    serve_launches, w20 = serve_app_phase(card)
    print(f"[apps] phases 18-20 wall {w18 + w19 + w20:.1f} s "
          f"({w18:.1f} + {w19:.1f} + {w20:.1f})")

    # --- 21-24. the parallel layer -------------------------------------------
    from lk_tpu_torch.parallel.multihost import init_multihost

    t_par = time.perf_counter()
    init_multihost(f"localhost:{free_port()}", 1, 0)       # NCCL, world 1
    walls = {}
    try:
        t0 = time.perf_counter()
        staging, _ = road_staging(dev)
        par_launches = {}
        par_launches["21"], _ = sharded_serving_phase(staging, ref_rows,
                                                      rates, card)
        del staging
        walls["21"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prev, nxt = spatial_pair(dev)
        spatial_launches = spatial_phase(prev, nxt, card)
        walls["22"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        par_launches["23"] = pyramidal_phase(prev, nxt, card)
        walls["23"] = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    world2 = world2_phase(prev, nxt, ref_rows, card)
    walls["24"] = time.perf_counter() - t0
    del prev, nxt
    print(f"[parallel] phases 21-24 wall {time.perf_counter() - t_par:.1f} s "
          f"({', '.join(f'{k}: {v:.1f}' for k, v in walls.items())})")

    report = {"kernels": [
        {"name": f"fused_lk_level[{v}]", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[v], "launches": launches[v],
         "max_abs_err": per_variant[v]["max_abs_err"],
         "ms": per_variant[v]["ms"], "event_ms": per_variant[v]["event_ms"],
         "plain_ms": per_variant[v]["plain_ms"],
         "bound_ms": per_variant[v]["bound_ms"],
         "bound_by": max(per_variant[v]["bound_by"].items(),
                         key=lambda kv: kv[1])[0],
         "library_ms": None}
        for v in REPLACES]}
    # launches on the parallel phases' sharded paths
    for entry in report["kernels"]:
        if entry["name"] == "fused_lk_level[tiled]":
            entry["parallel_launches"] = dict(
                {f"22 world 1, {m}": c["tiled"]
                 for m, c in spatial_launches.items()},
                **{f"24 world 2 rank {r}, {m}": w["spatial_launches"][
                    f"spatial_{int(per)}"]["tiled"]
                   for r, w in enumerate(world2)
                   for m, per, dcfg in spatial_modes()
                   if dcfg.use_pallas_fused})

    def par(name):
        out = {f"{ph} world 1": c[name] for ph, c in par_launches.items()
               if name in c}
        out.update({f"24 world 2 rank {r}": w["serve_launches"][name]
                    for r, w in enumerate(world2)})
        return out

    for k in s_kernels:
        report["kernels"].append(dict(
            k, launches=s_launches[k["name"]],
            serve_app_launches=serve_launches[k["name"]],
            parallel_launches=par(k["name"])))
        if k["name"] == "vp_scan":
            report["kernels"][-1]["single_stream_launches"] = v_launches[
                "vp_scan"]
    # launches: the dense video's; the single-stream run's and the apps'
    # beside it
    report["kernels"].append(dict(
        pyr_kernel, launches=launches["pyr_down"],
        single_stream_launches=v_launches["pyr_down"],
        app_launches=dict(app_launches, **t_launches,
                          serve=serve_launches["pyr_down"]),
        parallel_launches=par("pyr_down")))
    path_of = {"local_warp": "B", "fused_lk_level_precomputed": "B",
               "local_warp_bf16": "B16"}
    for k in p_kernels:
        report["kernels"].append(dict(
            k, launches=p_launches[path_of[k["name"]]][k["name"]]))
    print(f"[time] chip_smoke.py wall {time.perf_counter() - t_start:.1f} s "
          f"(the build included)")
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
