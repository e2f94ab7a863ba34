#!/usr/bin/env python3
"""How far lk_tpu_torch.apps.serve's device staging is from lk_tpu's cv2
staging, and what that does to the served VP rows (CPU; needs cv2).

Both stage the same synthetic BGR scenes (the port's stream, gray in
three equal channels) to u8 at the processing size: the port with its own
gray and f32 INTER_AREA on the device, rounded to u8; lk_tpu with
cv.cvtColor and cv.resize(INTER_AREA) on u8.  Prints the max |delta| in u8
levels and the share of pixels that differ, then runs the port's
MultiStreamPipeline (device="cpu") on both stagings and prints per stream
the csv row counts and the max |delta| of the rows they share.

    python3 scripts/torch_staging_vs_cv2.py [--streams 4] [--frames 33]
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import cv2 as cv
    import torch

    from lk_tpu_torch.apps import serve
    from lk_tpu_torch.models import PRESETS
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--frames", type=int, default=33)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    a = p.parse_args()
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    args = serve.build_parser().parse_args(
        ["--streams", str(a.streams), "--frames", str(a.frames),
         "--width", str(a.width), "--height", str(a.height)])
    cfg = dataclasses.replace(PRESETS["final"], out_cap=args.out_cap)
    h = cfg.derived_height(a.height, a.width)
    w = cfg.width
    scenes = serve.scenes_of(args, "cpu")
    ours = serve.stage(scenes, a.frames, h, w)
    ref = np.empty(tuple(ours.shape), np.uint8)
    for b, sc in enumerate(scenes):
        for t in range(a.frames):
            bgr = np.repeat(sc.frame(t)[..., None], 3, axis=-1)
            g = cv.cvtColor(bgr, cv.COLOR_BGR2GRAY)
            ref[t, b] = cv.resize(g, (w, h), interpolation=cv.INTER_AREA)
    d = np.abs(ours.numpy().astype(np.int16) - ref.astype(np.int16))
    print(f"staging {a.width}x{a.height} -> {w}x{h}, {a.streams} streams x "
          f"{a.frames} frames: max |delta| {d.max()} u8 levels, "
          f"{(d > 0).mean() * 100:.4f} % of pixels differ")

    rows = {}
    for name, u8 in (("port", ours), ("cv2", torch.from_numpy(ref))):
        ms = MultiStreamPipeline(cfg, src_size=(a.width, a.height),
                                 n_streams=a.streams, chunk=args.chunk,
                                 device="cpu")
        serve._feed_all(ms, u8, args)
        ms.drain()
        rows[name] = [np.array(q.csv_rows, np.float64).reshape(-1, 2)
                      for q in ms.pipes]
    for b, (x, y) in enumerate(zip(rows["port"], rows["cv2"])):
        n = min(len(x), len(y))
        dd = float(np.abs(x[:n] - y[:n]).max()) if n else 0.0
        print(f"stream {b}: csv rows {len(x)} (port staging) vs {len(y)} "
              f"(cv2 staging), max |delta| over the first {n}: {dd:.4g} px")


if __name__ == "__main__":
    main()
