"""lk.serve — multi-stream VP-pipeline serving benchmark: counterpart of
``lk_tpu.apps.serve``.

Runs N concurrent dashcam streams batched through ONE pipeline step on the
card (pipeline.runner.MultiStreamPipeline): the full VP pipeline — tracker,
flow-line geometry, cross points, VP state machine — for all streams in the
same step.  On CUDA tensors the port's kernels always run (the finish, the
tracker's window gather and its pyramid); ``lk_tpu``'s backend switch has
no counterpart.

The timed window measures the pipeline with frames pre-staged as processed
grayscale u8 on the device (``stage``: each synthetic scene rendered on the
card, gray, INTER_AREA-resized to the processing size and rounded to u8 —
``lk_tpu`` stages with cv2 on the host).  Output drains (device->host fetch
+ CSV bookkeeping) are inside the timed window.  ``run_server`` is the
whole run (warm-up pass, timed pass), returning the timed server and the
aggregate rate; ``main`` prints them.

Usage: python -m lk_tpu_torch.apps.serve --streams 32 --frames 64
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, NamedTuple, Optional

import torch

from lk_tpu_torch.io.video import SyntheticRoadStream
from lk_tpu_torch.models import PRESETS
from lk_tpu_torch.ops.resize import resize_area
from lk_tpu_torch.pipeline.runner import MultiStreamPipeline, _cached_finish


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--streams", type=int, default=32)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--drain-every", type=int, default=16,
                   help="most chunks whose rows may be outside the host "
                        "sinks; beyond, the oldest are booked at once")
    p.add_argument("--async-drains", action="store_true",
                   help="bookkeeping on a worker thread, from the chunks' "
                        "pinned host copies, instead of between the next "
                        "chunk's frames on the feeding thread")
    p.add_argument("--live-ingest", action="store_true",
                   help="render and stage per stream on producer threads "
                        "during the timed window (io.prefetch."
                        "MultiStreamPrefetcher) instead of pre-staging "
                        "clips on the device: serving incl. ingest overlap")
    p.add_argument("--device-preprocess", action="store_true",
                   help="stage u8 grays at SOURCE resolution and run the "
                        "reference's fixed-width INTER_AREA resize "
                        "(LK_Final.py:429,517) on the device inside the "
                        "timed window (e.g. --width 1920 --height 1080).  "
                        "Staging is F*B*H*W bytes of device memory")
    p.add_argument("--stage-window", type=int, default=0,
                   help="frames per staged device window (0 = stage the "
                        "whole run); each window is staged untimed, then "
                        "fed and drained timed")
    p.add_argument("--preset", default="final",
                   choices=("final", "vp_detect", "classify"),
                   help="pipeline preset (models.PRESETS)")
    p.add_argument("--out-cap", type=int, default=48,
                   help="per-frame average budget for the device-side "
                        "output-row compaction (PipelineConfig.out_cap); "
                        "0 transports the full 190-slot padding")
    p.add_argument("--quiet", action="store_true")
    return p


class ServeRun(NamedTuple):
    server: MultiStreamPipeline   # the timed pass's server, drained
    agg: float                    # stream-frames per second, timed window
    wall_s: float                 # the timed window
    decode_busy_s: Optional[float]   # --live-ingest: producer busy seconds


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    run = run_server(args, device=device)
    server = run.server
    if not args.quiet:
        print(f"streams: {args.streams}  frames: {server.frames_done}  "
              f"wall: {run.wall_s:.2f}s")
        src = (f" from {args.width}x{args.height} source, on-device "
               f"preprocess" if args.device_preprocess else "")
        print(f"aggregate: {run.agg:.1f} frames/s "
              f"({run.agg / 30:.1f} x 30fps streams at "
              f"{server.width}x{server.height}{src})")
        if run.decode_busy_s is not None:
            print(f"decode busy (all threads): {run.decode_busy_s:.2f}s "
                  f"across {args.streams} workers — overlap "
                  f"{run.decode_busy_s / max(run.wall_s, 1e-9):.1f}x wall")
        ok = sum(1 for p_ in server.pipes if len(p_.csv_rows) > 0)
        print(f"streams with VP output: {ok}/{args.streams}")
    return run.agg


def scenes_of(args, device) -> List[SyntheticRoadStream]:
    """The B synthetic streams (seed s, VP ((0.45 + 0.01 (s % 5)) W,
    0.45 H)), gray, rendered on ``device``."""
    return [
        SyntheticRoadStream(width=args.width, height=args.height,
                            n_frames=args.frames, seed=s, color=False,
                            vp=(args.width * (0.45 + 0.01 * (s % 5)),
                                args.height * 0.45), device=device)
        for s in range(args.streams)
    ]


def stage_gray(gray_u8: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., Hs, Ws) u8 gray -> (..., h, w) u8: INTER_AREA (f32 matmuls)
    and round to nearest even, on the tensor's device; the frames
    themselves when they have that size.  (cv.resize's u8 INTER_AREA
    rounds its own fixed arithmetic: a rare pixel differs by one level.)"""
    if tuple(gray_u8.shape[-2:]) == (h, w):
        return gray_u8
    g = resize_area(gray_u8.to(torch.float32), h, w)
    return torch.round(g).clamp(0, 255).to(torch.uint8)


def stage(scenes, n_frames: int, h: int, w: int) -> torch.Tensor:
    """Time-major (F, B, h, w) u8 staging of the scenes' first F frames on
    their device.  A scene's gray frame is what cv.cvtColor(BGR2GRAY)
    gives for its three equal BGR channels, exactly."""
    dev = scenes[0].device
    out = torch.empty((n_frames, len(scenes), h, w), dtype=torch.uint8,
                      device=dev)
    for b, sc in enumerate(scenes):
        out[:, b] = stage_gray(sc.gray_frames(0, n_frames), h, w)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_server(args, device="cuda") -> ServeRun:
    """The serving run of ``args`` on ``device``: an untimed warm-up pass
    through a throwaway server, then the timed pass."""
    device = torch.device(device)
    # out_cap: compact the update/CP row transport on the device (exact,
    # counts checked on drain)
    cfg = dataclasses.replace(PRESETS[args.preset], out_cap=args.out_cap)
    scenes = scenes_of(args, device)

    def make():
        s = MultiStreamPipeline(cfg, src_size=(args.width, args.height),
                                n_streams=args.streams, chunk=args.chunk,
                                device=device)
        s.drain_every = args.drain_every
        return s

    server = make()
    if args.async_drains:
        server.start_async_drains()
    # warm-up pass, untimed, with every chunk shape feed() will see
    warm = make()
    decode_busy = None
    if args.live_ingest:
        # render + stage + upload + pipeline all overlap
        _feed_live(warm, scenes, args)
        warm.drain()
        _sync(device)
        t0 = time.perf_counter()
        decode_busy = _feed_live(server, scenes, args)
        server.drain()
        _sync(device)
        dt = time.perf_counter() - t0
    else:
        # pre-staged u8 grays on the device, untimed: at SOURCE resolution
        # with --device-preprocess (the resize then runs inside the timed
        # feed), else at the processing size
        if args.device_preprocess:
            h, w = args.height, args.width
        else:
            h, w = server.height, server.width
        if args.stage_window:
            _feed_windowed(warm, scenes, h, w, args)
            dt = _feed_windowed(server, scenes, h, w, args)
        else:
            grays = stage(scenes, args.frames, h, w)
            _sync(device)
            _feed_all(warm, grays, args)
            warm.drain()
            _sync(device)
            t0 = time.perf_counter()
            _feed_all(server, grays, args)
            server.drain()
            _sync(device)
            dt = time.perf_counter() - t0
    return ServeRun(server, server.frames_done / dt, dt, decode_busy)


def _feed_live(server: MultiStreamPipeline, scenes, args) -> float:
    """Feed via per-stream producer threads (each renders and stages its
    scene's frames) + batched upload and finish on the coordinator thread;
    returns total producer busy seconds (the overlap evidence)."""
    from lk_tpu_torch.io.prefetch import MultiStreamPrefetcher

    h, w = server.height, server.width
    finish = _cached_finish(server.cfg)

    def gray_stream(scene):
        for t in range(args.frames):
            yield stage_gray(scene.gray_frames(t, 1)[0], h, w).cpu().numpy()

    def batch_transform(u8_batch):    # (B, n, h, w) u8, coordinator thread
        b, n = u8_batch.shape[:2]
        x = torch.from_numpy(u8_batch.reshape(b * n, h, w)).to(server.device)
        return finish(x).reshape(b, n, h, w)

    mp = MultiStreamPrefetcher(
        [gray_stream(s) for s in scenes], chunk=args.chunk, depth=2,
        first_extra=1, batch_transform=batch_transform,
    )
    try:
        for batch in mp:
            server.feed_processed(batch)
    finally:
        mp.close()
    return mp.decode_busy_s


def _feed_windowed(server: MultiStreamPipeline, scenes, h: int, w: int,
                   args) -> float:
    """Feed in --stage-window frame windows: stage each window untimed,
    feed + drain it timed; returns summed timed seconds (each timed
    segment ends at the drain's device sync)."""
    timed = 0.0
    f = args.frames
    tg = 0
    while tg < f:
        n_win = min(args.stage_window, f - tg)
        g = torch.stack([stage_gray(sc.gray_frames(tg, n_win), h, w)
                         for sc in scenes], dim=1)
        _sync(server.device)
        t0 = time.perf_counter()
        t = 0
        while t < n_win:
            n = min(args.chunk + (1 if server.states is None else 0),
                    n_win - t)
            server.feed_staged(g, t, n)
            t += n
        server.drain()
        _sync(server.device)
        timed += time.perf_counter() - t0
        tg += n_win
    return timed


def _feed_all(server: MultiStreamPipeline, grays, args) -> None:
    """Feed a time-major (F, B, h, w) u8 staging tensor, one chunk per
    call (slice + finish + steps; see feed_staged)."""
    t = 0
    f = args.frames
    while t < f:
        # the first feed consumes one extra frame for initialization
        n = min(args.chunk + (1 if server.states is None else 0), f - t)
        server.feed_staged(grays, t, n)
        t += n


if __name__ == "__main__":
    main()
