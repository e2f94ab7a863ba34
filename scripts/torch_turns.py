#!/usr/bin/env python3
"""One turn of a comparison between two trees of the PyTorch/CUDA port
(lk_tpu_torch) on one NVIDIA GPU.

Imports ``lk_tpu_torch`` from TREE (a checkout, e.g. one unpacked with
``git archive``) and this checkout's ``chip_smoke.py`` for its scenes and
timers, then prints, for TREE's package:

* the serving finish on one chunk (1024x483x860 u8), the precomputed-A
  level on path B's 1080p top (136x240, 6 iterations) and the local warp
  at path B's levels 0-2 (1088x1920, 576x1024, 320x480): device time per
  call from a counted torch.profiler trace, with the launches per call;
* dense video pairs/s (34 frames at 1080p, CUDA events), ms per pair of
  path B, serving stream-frames/s (64 streams x 64 frames, best of 2
  passes after a warm-up pass);
* sha256 digests of the precomputed level's and the local warp's outputs,
  the video's flow, paths A and B's flow and the serving csv rows: equal
  across trees whose outputs are bit-equal.

Compare two trees in turns, in one session on one card (host speed
drifts between calls): build both first, then parent, change, change,
parent::

    python3 scripts/torch_turns.py --tree PARENT --build-only
    python3 scripts/torch_turns.py --tree PARENT
    python3 scripts/torch_turns.py --tree CHANGE
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout whose "
                    "lk_tpu_torch is measured")
    ap.add_argument("--build-only", action="store_true",
                    help="build TREE's kernel library and stop")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_turns: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py, whatever TREE holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import lk_tpu_torch
    from lk_tpu_torch import _build

    cs.check(os.path.dirname(os.path.abspath(lk_tpu_torch.__file__))
             == os.path.join(tree, "lk_tpu_torch"),
             f"lk_tpu_torch imported from {lk_tpu_torch.__file__}")
    t0 = time.perf_counter()
    _build.library()
    name = os.path.basename(tree)
    print(f"[turn {name}] kernel library {_build.build_dir()}: "
          f"{time.perf_counter() - t0:.1f} s")
    if opt.build_only:
        return 0

    from lk_tpu_torch.entry import entry
    from lk_tpu_torch.flow import dense
    from lk_tpu_torch.flow import lk_kernels as lk
    from lk_tpu_torch.flow import warp_kernels as wk
    from lk_tpu_torch.ops import blur, finish

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    dev = cs.device()

    def say(msg):
        print(f"[turn {name}] {msg}  [{card}]", flush=True)

    # --- the finish on one serving chunk -----------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    chunk = torch.randint(0, 256, (cs.SB * cs.S_CHUNK, cs.SH, cs.SW),
                          dtype=torch.uint8, device=dev, generator=g)
    finish.reset_counters()
    out = finish.fused_finish(chunk)
    n = finish.kernel_launches
    us = cs.device_us(lambda: finish.fused_finish(chunk),
                      {"finish_kernel": n})
    b_ms, _ = cs.bound(chunk.numel() * 5, chunk.numel() * 10)
    say(f"finish {tuple(chunk.shape)} u8: device {us / 1e3:.4f} ms in {n} "
        f"launch(es), bound {b_ms:.4f} ms ({b_ms / us * 1e3:.1%}); output "
        f"{digest([out.cpu().numpy()])}")
    del chunk, out

    # --- the precomputed level at path B's top ---------------------------
    cfg, dcfg = cs.configs()
    rng = np.random.default_rng(1234)     # chip_smoke.py's first scene
    frames = torch.from_numpy(cs.affine_video(
        rng, cs.H, cs.W, cs.FRAMES, cs.translation(3.7, -2.2))).to(dev)
    bcfg = cs.path_cfg("B")
    level, _, lcfg, (_, th, tw, hp, wp) = next(
        lv for lv in cs.path_levels("B", cfg) if lv[2].use_pallas_fused)
    prev, nxt = (blur.edge_pad(dense.build_frame_levels(f, cfg, bcfg)[level],
                               hp, wp).contiguous()
                 for f in (frames[0], frames[1]))
    ix, iy, a11, a12, a22, _, _, inv_det = dense.level_prologue(
        prev, cfg, "edge")
    flow = cs.zoom_flow(hp, wp, dev, outliers=True) * 0.25
    args = (nxt, prev, ix, iy, a11, a12, a22, inv_det, flow)
    kw = dict(n_iters=lcfg.outer_iters, max_disp=lcfg.level_disp(level),
              tile_h=th, tile_w=tw, local=lcfg.warp_local,
              win_k=cfg.win_size[1])
    wk.reset_counters()
    out = wk.fused_lk_level_precomputed(*args, **kw)
    n = wk.kernel_launches["fused_lk_level_precomputed"]
    us = cs.device_us(lambda: wk.fused_lk_level_precomputed(*args, **kw),
                      {"fused_level_pre_kernel": n})
    say(f"precomputed level L{level} {hp}x{wp} tile {th}x{tw} x"
        f"{kw['n_iters']}: device {us:.1f} us in {n} launch(es); output "
        f"{digest([out.cpu().numpy()])}")
    del args, out

    # --- the local warp at path B's levels 0-2 ---------------------------
    nxt_levels = dense.build_frame_levels(frames[1], cfg, bcfg)
    total, outs = 0.0, []
    for level, _, lcfg, (_, th, tw, hp, wp) in cs.path_levels("B", cfg):
        if lcfg.use_pallas_fused:
            continue
        nxt = blur.edge_pad(nxt_levels[level], hp, wp).contiguous()
        flow = cs.zoom_flow(hp, wp, dev, outliers=True)
        kw = dict(max_disp=lcfg.level_disp(level), tile_h=th, tile_w=tw,
                  local=lcfg.warp_local)
        wk.reset_counters()
        outs.append(wk.local_warp(nxt, flow, **kw).cpu().numpy())
        n = wk.kernel_launches["local_warp"]
        us = cs.device_us(lambda: wk.local_warp(nxt, flow, **kw),
                          {"local_warp_kernel": n})
        total += us
        say(f"local warp L{level} {hp}x{wp} tile {th}x{tw} local "
            f"{kw['local']}: device {us:.1f} us in {n} launch(es)")
    say(f"local warp L0-L2: device {total:.1f} us; output {digest(outs)}")
    del nxt_levels, outs

    # --- paths A and B per pair, the video -------------------------------
    fn, _ = entry()
    f0, f1 = frames[0], frames[1]
    flow_a = fn(f0, f1)
    # the counters dense_counts() reads; chip_smoke's reset_counters() also
    # resets modules that older trees lack
    for module in (lk, wk, blur):
        module.reset_counters()
    res_b = dense.dense_pyramidal_lk(f0, f1, cfg, None, bcfg)
    torch.cuda.synchronize()
    counts, _ = cs.dense_counts()
    ms_b = cs.cuda_ms(lambda: dense.dense_pyramidal_lk(
        f0, f1, cfg, dense_cfg=bcfg), 10)
    say(f"path B: {ms_b:.3f} ms per pair, kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }; flow digests A "
        f"{digest([flow_a.cpu().numpy()])}, B "
        f"{digest([t.cpu().numpy() for t in res_b])}")
    video = dense.dense_pyramidal_lk_video(frames, cfg, dcfg)
    v_digest = digest([t.cpu().numpy() for t in video])
    del video
    ms_v = min(cs.cuda_ms(lambda: dense.dense_pyramidal_lk_video(
        frames, cfg, dcfg), 3) for _ in range(2))
    pairs = cs.FRAMES - 1
    say(f"video {cs.FRAMES}x{cs.H}x{cs.W}: {ms_v:.2f} ms = "
        f"{pairs / ms_v * 1e3:.1f} pairs/s; flow digest {v_digest}")
    del frames, flow_a, res_b

    # --- serving ------------------------------------------------------
    staging, _ = cs.road_staging(dev)
    ms = cs.serve_pass(staging)               # warm-up
    rows = digest([np.array(p.csv_rows, np.float64) for p in ms.pipes])
    del ms
    rates = cs.serving_timing(staging, card)
    say(f"serving B={cs.SB} {cs.SW}x{cs.SH}: {max(rates):.1f} "
        f"stream-frames/s (best of {len(rates)} passes); csv digest {rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
