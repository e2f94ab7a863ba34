#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lk_tpu_torch) on one NVIDIA GPU.

Drives the port's main path — dense pyramidal LK over 1080p video with the
production config — and checks it:

  0. environment: the card's name and power limit, torch, CUDA, nvcc;
  1. build: compiles the CUDA kernel from csrc/ (nvcc) and times it;
  2. kernel vs plain PyTorch version at the 1080p plan shapes, K=4 pairs
     (top level 136x256 with 6 iterations; L2, L1, L0 coarse-in, stats at
     L0), and chunk output vs single-pair output, bit for bit;
  3. main path: dense_pyramidal_lk_video on two synthetic 34-frame 1080p
     scenes (8 chunks of 4 pairs plus a 1-pair tail), with the launch
     counters reset just before and read just after; mean EPE vs exact
     ground truth on bench.py's grid must be < 0.1 px;
  4. timing with CUDA events: pairs/s (output flow fields per second) of
     the chained video through the kernel and through the plain version,
     per-level kernel vs plain;
  5. only with --profile: host enqueue and wall per video, and a
     torch.profiler breakdown of its device time by kernel group.

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
    from lk_tpu.config import DenseLKConfig, LKConfig

    return LKConfig(), DenseLKConfig(use_pallas_warp=True, pallas_pyramid=True)


def device():
    import torch

    return torch.device("cuda", 0)


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
                var, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
            v["max_abs_err"] = max(v["max_abs_err"], err)
            v["ms"] += ms
            v["plain_ms"] += pms
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
    print(f"[build] fused_lk_level: {time.perf_counter() - t0:.1f} s "
          f"({nvcc}) -> {_build.build_dir()}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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
        lk.reset_counters()
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
    report = {"kernels": [
        {"name": f"fused_lk_level[{v}]", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[v], "launches": launches[v],
         "max_abs_err": per_variant[v]["max_abs_err"],
         "ms": per_variant[v]["ms"], "plain_ms": per_variant[v]["plain_ms"]}
        for v in REPLACES]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
