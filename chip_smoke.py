#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lk_tpu_torch) on one NVIDIA GPU.

Drives the port's two paths and checks them.  The dense path: pyramidal
LK over 1080p video with the production config.  The serving path:
batched VP serving, MultiStreamPipeline at 64 streams of 860x483 frames,
chunk 16, out_cap 48, preset final, fed from a u8 staging array on the
card, as apps/serve.py runs it.

  0. environment: the card's name and power limit, torch, CUDA, nvcc;
  1. build: compiles every CUDA kernel in csrc/ (one nvcc per source, in
     parallel) and prints each kernel's registers, shared memory, spills;
  2. dense kernel vs plain PyTorch version at the 1080p plan shapes, K=4
     pairs (top level 136x256 with 6 iterations; L2, L1, L0 coarse-in,
     stats at L0), and chunk output vs single-pair output, bit for bit;
  3. dense main path: dense_pyramidal_lk_video on two synthetic 34-frame
     1080p scenes (8 chunks of 4 pairs plus a 1-pair tail), with the
     launch counters reset just before and read just after; mean EPE vs
     exact ground truth on bench.py's grid must be < 0.1 px;
  4. dense timing with CUDA events: pairs/s (output flow fields per second)
     of the chained video through the kernel and through the plain version;
  5. only with --profile: host enqueue and wall per video, and a
     torch.profiler breakdown of its device time by kernel group;
  6. serving scenes: 64 synthetic road streams expanding from a planted
     VP per stream (apps/serve.py's), textures made with numpy/scipy, the
     64-frame staging array rendered on the card;
  7. serving main path: one pass of MultiStreamPipeline.feed_staged +
     drain, counters reset just before and read just after (the finish
     kernel once per chunk plus once for the init frame, the window gather
     three times per processed frame, no plain call); every stream runs
     63 frames, the mean late-trajectory VP error is < 25 px
     (tests/test_pipeline_e2e.py's bound); the first 4 streams run again
     through the plain versions on the card give the same csv rows;
  8. serving kernels vs plain at serving shapes: the finish on (1024, 483,
     860) u8 with and without the tone curve and on an odd shape, the
     gather on the three folded levels of the 64-stream batch with the
     tracker's frame-major point set and a shuffled one; ms per launch;
  9. serving timing: aggregate stream-frames/s with CUDA events around
     whole feed_staged + drain passes after the warm-up pass of phase 7;
 10. only with --profile: the serving pass's device and host time by
     stage, and the device's busy share.

Prints a {"kernels": [...]} JSON line, the card line, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the exit code is
then non-zero and no result line is printed.  Without a CUDA device, or run
from a directory without the package, it exits non-zero at once.

    python3 chip_smoke.py [--profile]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1920
FRAMES = 34               # 33 pairs = 8 chunks of 4 + a 1-pair tail
K = 4                     # pairs per chunk (DenseLKConfig.video_chunk)
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


def configs():
    """The production config: bench.py's DenseLKConfig, LKConfig defaults."""
    from lk_tpu_torch.config import DenseLKConfig, LKConfig

    return LKConfig(), DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) for moving nbytes and doing ops f32
    operations on one H100 at its published peaks."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def device():
    import torch

    return torch.device("cuda", 0)


def reset_counters() -> None:
    """Every kernel wrapper's launch and plain-call counts to 0."""
    from lk_tpu_torch.flow import lk_kernels, sparse
    from lk_tpu_torch.ops import finish

    for module in (lk_kernels, finish, sparse):
        module.reset_counters()


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
    same input.  Returns per-variant {max_abs_err, ms, plain_ms} and the
    per-level report rows."""
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
            pms = cuda_ms(lambda: lk.fused_lk_level_reference(*args, **kw),
                          max(1, timing_reps // 10))
            rows.append((k, name, var, err, eig, flips, ms, pms))
            v = per_variant.setdefault(
                var, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": {}})
            v["max_abs_err"] = max(v["max_abs_err"], err)
            v["ms"] += ms
            v["plain_ms"] += pms
            b_ms, b_by = level_bound(k, *st.shape[1:], kw)
            v["bound_ms"] += b_ms
            v["bound_by"][b_by] = v["bound_by"].get(b_by, 0.0) + b_ms
    return per_variant, rows


def profile_video(run_video, card: str, reps: int = 3) -> None:
    """Phase 5 (--profile): where the device time of the 1080p video goes.
    Host enqueue and wall per video without the profiler, then a
    torch.profiler trace of ``reps`` videos: device ms per video by kernel
    group, and the busy share of the traced device span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_video()
    torch.cuda.synchronize()
    for _ in range(3):
        t0 = time.perf_counter()
        run_video()
        enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[profile] video: host enqueue {enq * 1e3:.2f} ms, wall "
              f"{wall * 1e3:.2f} ms  [{card}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_video()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(kernels), "the profiler saw no device time")
    groups = {}
    for e in kernels:
        name = e.name
        group = ("fused_lk_level_kernel" if "fused_lk_level" in name
                 else "gather / index_select" if ("gather" in name
                                                  or "index" in name)
                 else "cat" if "Cat" in name
                 else "elementwise (mul/add)" if "elementwise" in name
                 else "other")
        n, us = groups.get(group, (0, 0.0))
        groups[group] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in groups.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    for group, (n, us) in sorted(groups.items(), key=lambda g: -g[1][1]):
        print(f"[profile] {group}: {us / reps / 1e3:.3f} ms per video "
              f"({n // reps} launches), {us / busy:.1%} of device time  "
              f"[{card}]")
    print(f"[profile] device busy {busy / reps / 1e3:.3f} ms per video, "
          f"{busy / span:.1%} of the traced device span "
          f"({span / reps / 1e3:.3f} ms per video)  [{card}]")


# --------------------------------------------------------------------------
# serving: scenes, main path, kernels vs plain, timing, profile
# --------------------------------------------------------------------------

def road_staging(dev, n_streams=SB, n_frames=SF, h=SH, w=SW, zoom=S_ZOOM,
                 n_tex=16, seed=7):
    """(n_frames, n_streams, h, w) u8 staging of forward-driving scenes, as
    lk_tpu.io.video.SyntheticRoadStream makes them: a blurred-noise texture
    1.6x the frame expanding from the stream's planted VP by ``zoom`` per
    frame (bilinear, REFLECT_101), clipped and truncated to u8.  Stream s
    takes texture s % n_tex and apps/serve.py's VP (0.45 + 0.01 (s % 5)) w,
    0.45 h.  Textures on the host (numpy/scipy), frames on the card."""
    import torch
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    th, tw = int(h * 1.6), int(w * 1.6)
    texs = []
    for _ in range(n_tex):
        tex = gaussian_filter(rng.random((th, tw), dtype=np.float32) * 255,
                              1.5, mode="mirror")
        tex += gaussian_filter(rng.random((th, tw), dtype=np.float32) * 255,
                               6.0, mode="mirror")
        texs.append((tex - tex.min()) / (tex.max() - tex.min()) * 255)
    tex = torch.from_numpy(np.stack(texs)).to(dev)
    out = torch.empty((n_frames, n_streams, h, w), dtype=torch.uint8,
                      device=dev)
    ys = torch.arange(h, dtype=torch.float64, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float64, device=dev)[None, None, :]
    scale = zoom ** -torch.arange(n_frames, dtype=torch.float64,
                                  device=dev)[:, None, None]

    def refl(i, n):
        i = i.abs()
        return torch.where(i >= n, 2 * n - 2 - i, i).clamp(0, n - 1)

    vps = []
    for s in range(n_streams):
        vx, vy = w * (0.45 + 0.01 * (s % 5)), h * 0.45
        vps.append((vx, vy))
        gx = (scale * xs + (1 - scale) * vx + (tw - w) / 2.0).float()
        gy = (scale * ys + (1 - scale) * vy + (th - h) / 2.0).float()
        x0, y0 = torch.floor(gx), torch.floor(gy)
        fx, fy = gx - x0, gy - y0
        x0, y0 = x0.long(), y0.long()
        t = tex[s % n_tex].reshape(-1)

        def at(yy, xx):
            return t[refl(yy, th) * tw + refl(xx, tw)]

        v = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
             + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))
        out[:, s] = v.clamp(0, 255).to(torch.uint8)
    return out, np.array(vps)


def serving_config():
    import dataclasses

    from lk_tpu_torch.models import PRESETS

    return dataclasses.replace(PRESETS["final"], out_cap=S_CAP)


def serve_pass(staging, n_streams=SB):
    """One serving pass: a fresh MultiStreamPipeline fed the whole staging
    array in chunks (the first one chunk + the init frame), then drained."""
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    ms = MultiStreamPipeline(serving_config(), src_size=SRC,
                             n_streams=n_streams, chunk=S_CHUNK)
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
    attributes the path looks up at call time), for comparison runs."""
    import contextlib

    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.ops import finish

    @contextlib.contextmanager
    def ctx():
        old = finish.fused_finish, sparse.gather_windows
        finish.fused_finish = finish.fused_finish_reference
        sparse.gather_windows = sparse.gather_windows_reference
        try:
            yield
        finally:
            finish.fused_finish, sparse.gather_windows = old

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
    """Phase 7: the counted serving pass, its checks, and the 4-stream
    plain-path comparison.  Returns (launch counts, the pass)."""
    import torch
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.ops import finish

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ms = serve_pass(staging)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"finish": finish.kernel_launches,
                "window_gather": sparse.kernel_launches}
    plain = finish.plain_calls + sparse.plain_calls
    frames = SF - 1
    print(f"[serve] B={SB} {SW}x{SH} chunk {S_CHUNK} out_cap {S_CAP} preset "
          f"final, {SF} staged frames: launches {launches}, plain calls "
          f"{plain}, first pass {wall:.2f} s (incl. warm-up)  [{card}]")
    check(plain == 0, f"plain versions ran {plain}x on the card")
    check(launches["finish"] == n_chunks() + 1,
          f"finish launches {launches['finish']} != {n_chunks() + 1}")
    check(launches["window_gather"] == 3 * frames,
          f"gather launches {launches['window_gather']} != {3 * frames}")
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


def record_gathers(staging):
    """The window-gather calls of one frame step of the 64-stream batch
    (levels 2, 1, 0: the frame-major point set the tracker builds), taken
    by a recording wrapper around the kernel's wrapper (the step's outputs
    are not drained)."""
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    calls = []
    real = sparse.gather_windows

    def rec(*args):
        calls.append(args)
        return real(*args)

    sparse.gather_windows = rec
    try:
        MultiStreamPipeline(serving_config(), src_size=SRC,
                            n_streams=SB, chunk=S_CHUNK).feed_staged(
            staging, 0, 2)
    finally:
        sparse.gather_windows = real
    return calls


def gather_bound(n, win_h, win_w, sw_h, sw_w):
    """Least time of one gather: the windows read once (prev window with
    its Scharr halo, superwindow), the outputs written once; ~40 f32
    operations per prev-window pixel (two smoothed columns and rows and
    two differences, each 3 products and 2 sums)."""
    read = n * ((win_h + 3) * (win_w + 3) + sw_h * sw_w) * 4
    written = n * (3 * (win_h + 1) * (win_w + 1) + sw_h * sw_w) * 4
    return bound(read + written, n * (win_h + 1) * (win_w + 1) * 40)


def serving_kernels(staging, card, reps=20):
    """Phase 8: the finish and the gather against their plain versions at
    the serving shapes; returns their report entries."""
    import torch
    from lk_tpu_torch.flow import sparse
    from lk_tpu_torch.ops import finish

    def cmp(a, b):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
        return float((a - b).abs().max())

    # --- finish: a whole chunk (64 streams x 16 frames), and odd shapes ---
    chunk = staging[1:1 + S_CHUNK].reshape(-1, SH, SW)
    odd = staging[:3, 0, :37, :53].contiguous()
    err_f = 0.0
    for x, label in ((chunk, f"{tuple(chunk.shape)} u8"),
                     (odd, f"{tuple(odd.shape)} u8")):
        for contrast in (False, True):
            e = cmp(finish.fused_finish(x, contrast),
                    finish.fused_finish_reference(x, contrast))
            print(f"[kernel] finish {label} contrast={contrast}: max|d| "
                  f"{e:.3g}")
            check(e <= KERNEL_TOL, f"finish {label}: max|d| {e}")
            err_f = max(err_f, e)
    ms_f = cuda_ms(lambda: finish.fused_finish(chunk), reps)
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
          f"kernel {ms_f:.3f} ms (tone on {ms_ft:.3f}), plain {pms_f:.3f} "
          f"ms, bound {b_f:.3f} ms ({by_f}), library nn.Conv2d reflect on "
          f"the f32 frames {lib_f:.3f} ms (max|d| {lib_err:.3g})  [{card}]")

    # --- gather: the tracker's calls of one frame step, and shuffled -------
    calls = record_gathers(staging)
    err_g, ms_g, pms_g, b_g, by_g = 0.0, [], [], [], set()
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
        pms_g.append(cuda_ms(lambda: sparse.gather_windows_reference(*a), 5))
        bm, bb = gather_bound(n, wh, ww, swh, sww)
        b_g.append(bm)
        by_g.add(bb)
        print(f"[kernel] window_gather level {2 - i}: folded "
              f"{tuple(prev_f.shape)}, {n} points, frame-major and "
              f"shuffled max|d| {err_g:.3g}; kernel {ms_g[-1]:.4f} ms, "
              f"plain {pms_g[-1]:.3f} ms, bound {bm:.4f} ms ({bb})  "
              f"[{card}]")
    return [
        {"name": "finish", "route": "cuda",
         "source": "lk_tpu_torch/csrc/finish.cu",
         "replaces": "lk_tpu/ops/pallas_finish.py:114",
         "max_abs_err": err_f, "ms": ms_f, "plain_ms": pms_f,
         "bound_ms": b_f, "bound_by": by_f, "library_ms": lib_f},
        {"name": "window_gather", "route": "cuda",
         "source": "lk_tpu_torch/csrc/window_gather.cu",
         "replaces": "lk_tpu/flow/pallas_kernels.py:2358",
         "max_abs_err": err_g, "ms": float(np.mean(ms_g)),
         "plain_ms": float(np.mean(pms_g)),
         "bound_ms": float(np.mean(b_g)),
         "bound_by": "bytes" if by_g == {"bytes"} else "operations",
         "library_ms": None},
    ]


def serving_timing(staging, card, passes=2):
    """Phase 9: aggregate stream-frames/s of whole passes (feed_staged +
    drain), CUDA events, after phase 7's warm-up pass."""
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
          "step.detect", "step.vp_scan", "serve.compact", "serve.drain")


def profile_serving(staging, card):
    """Phase 10 (--profile): where a serving pass's time goes, by the
    port's profiler ranges.  The ranges appear twice in the trace: as CPU
    ranges (host time inside each stage) and as annotations on the device
    timeline; each kernel counts for the stage whose device annotation
    holds its start.  Also the device's busy share: kernel time over the
    span from the first kernel's start to the last one's end."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_pass(staging)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev_events = [e for e in events if e.device_type == DeviceType.CUDA]
    ann = sorted((e for e in dev_events if e.name in STAGES),
                 key=lambda e: e.time_range.start)
    kernels = [e for e in dev_events if e.name not in STAGES
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
        if e.name in STAGES and e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(us for _, us in dev.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    frames = SF - 1
    for st in STAGES + ("other",):
        n, us = dev.get(st, (0, 0.0))
        h = host.get(st)
        hs = ("" if h is None else
              f", host {h / 1e3 / frames:.2f} ms per frame "
              f"({h / 1e6 / wall:.1%} of the pass)")
        print(f"[profile] serving {st}: device {us / 1e3 / frames:.3f} ms "
              f"per frame ({us / busy:.1%} of device time, "
              f"{n / frames:.0f} launches per frame){hs}  [{card}]")
    print(f"[profile] serving pass under the profiler: wall {wall:.2f} s, "
          f"device busy {busy / 1e3:.1f} ms = {busy / span:.1%} of the "
          f"traced device span ({span / 1e3:.1f} ms), {len(kernels)} "
          f"kernel launches = {len(kernels) / frames:.0f} per frame  "
          f"[{card}]")


def main() -> int:
    import torch

    profile = "--profile" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lk_tpu_torch import _build
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import lk_kernels as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device()

    # --- 0. environment -------------------------------------------------------
    card = card_line()
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[env] nvcc: {sh([_build._nvcc(), '--version']).splitlines()[-1]}")

    # --- 1. build -------------------------------------------------------------
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

    # --- 2. kernel vs plain at the 1080p plan shapes ---------------------------
    frames0 = torch.from_numpy(scenes[0][2]).to(dev)
    stacks = dense.build_frame_levels(frames0[:K + 1], cfg, dcfg)
    per_variant, rows = compare_levels(stacks, plan, cfg, timing_reps=20)
    for k, name, var, err, eig, flips, ms, pms in rows:
        print(f"[kernel] K={k} {name} ({var}): max|dflow| {err:.3g} px, "
              f"max rel dmin_eig {eig:.3g}, valid flips {flips:.3g}; "
              f"kernel {ms:.3f} ms ({ms / k:.3f} ms/pair), plain "
              f"{pms:.3f} ms  [{card}]")
    print(f"[kernel] chunk (K={K}) output == single-pair output: "
          "bit-identical")

    # --- 3. main path -------------------------------------------------------------
    launches = None
    for label, a, frames_np in scenes:
        frames = torch.from_numpy(frames_np).to(dev)
        torch.cuda.synchronize()
        reset_counters()
        out = dense.dense_pyramidal_lk_video(frames, cfg, dcfg)
        torch.cuda.synchronize()
        counts = dict(lk.kernel_launches_by_variant)
        check(lk.plain_calls == 0, f"plain version ran {lk.plain_calls}x")
        check(all(n > 0 for n in counts.values()),
              f"a kernel variant never launched: {counts}")
        if launches is None:
            launches = counts
        flow = out.flow.cpu().numpy()
        check(flow.shape == (FRAMES - 1, H, W, 2), f"flow {flow.shape}")
        check(bool(np.isfinite(flow).all()), "non-finite flow")
        check(tuple(out.min_eig.shape) == (FRAMES - 1, H, W)
              and out.valid.dtype == torch.bool, "stats shape/dtype")
        epe = mean_epe(flow, a)
        print(f"[main] {label}: {FRAMES} frames -> flow {flow.shape}, "
              f"launches {counts}, plain calls {lk.plain_calls}, "
              f"valid {float(out.valid.float().mean()):.4f}, mean EPE vs "
              f"ground truth {epe:.4f} px (limit {EPE_LIMIT})")
        check(epe < EPE_LIMIT, f"{label}: EPE {epe} >= {EPE_LIMIT}")
    del out, frames

    # --- 4. timing: the chained 1080p video, kernel vs plain ------------------
    frames = frames0

    def run_video():
        dense.dense_pyramidal_lk_video(frames, cfg, dcfg)

    def run_video_plain():
        # dense.py looks fused_lk_level up at call time: point it at the
        # plain version for this run only
        dense.fused_lk_level = lk.fused_lk_level_reference
        try:
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
        profile_video(run_video, card)
    del frames, frames0, stacks, scenes

    # --- 6. serving scenes ------------------------------------------------------
    t0 = time.perf_counter()
    staging, vps = road_staging(dev)
    torch.cuda.synchronize()
    print(f"[data] serving staging {tuple(staging.shape)} u8: "
          f"{time.perf_counter() - t0:.1f} s (set-up)")

    # --- 7. serving main path ----------------------------------------------------
    s_launches, _ = serving_main_path(staging, vps, card)

    # --- 8. serving kernels vs plain at serving shapes ---------------------------
    s_kernels = serving_kernels(staging, card)

    # --- 9. serving timing ---------------------------------------------------------
    rates = serving_timing(staging, card)
    print(f"[time] serving B={SB} {SW}x{SH}: aggregate "
          f"{max(rates):.1f} stream-frames/s (best of {len(rates)} passes; "
          f"{max(rates) / 30:.1f} x 30 fps streams)  [{card}]")
    if profile:
        profile_serving(staging, card)

    report = {"kernels": [
        {"name": f"fused_lk_level[{v}]", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[v], "launches": launches[v],
         "max_abs_err": per_variant[v]["max_abs_err"],
         "ms": per_variant[v]["ms"], "plain_ms": per_variant[v]["plain_ms"],
         "bound_ms": per_variant[v]["bound_ms"],
         "bound_by": max(per_variant[v]["bound_by"].items(),
                         key=lambda kv: kv[1])[0],
         "library_ms": None}
        for v in REPLACES]}
    for k in s_kernels:
        report["kernels"].append(dict(k, launches=s_launches[k["name"]]))
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
