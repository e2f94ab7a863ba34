"""Dry run of the parallel layer on gloo CPU ranks: counterpart of
``__graft_entry__.dryrun_multichip`` (its ``_dryrun_impl``'s five legs).

``dryrun_multichip(n_ranks)`` starts ``n_ranks`` OS processes (gloo, one
PyTorch thread each, a free localhost port), each one rank of the world,
and runs on them:

1. the stream data-parallel pipeline step (``shard_pipeline_step``) on the
   default data x spatial mesh, 2 streams per data shard, 128x96;
2. the spatial dense LK level at 1080p over ``n_ranks`` row shards
   (production window 15, 6 iterations, displacement bound 8);
3. the row-sharded pyramidal solve at 1080p (``sharded_dense_pyramidal_lk``)
   against the unsharded ``dense_pyramidal_lk``;
4. sharded serving (``MultiStreamPipeline(mesh=...)``, ``feed_staged``) at
   860x483, 2 streams per rank x 9 frames, chunk 8;
5. dense stream data-parallelism: the production dense video config
   (``entry``'s: pyramid kernel, fused level) on 2 streams per rank of 9
   frames (two chunks of 4 pairs) at 272x480, against the unsharded run.

Each leg prints one line; a failed leg raises in its rank, and
``dryrun_multichip`` raises when any rank fails or outlives its timeout.

    python -c "from lk_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

DP_TOL = 1e-5           # px, __graft_entry__.py:211
RANK_TIMEOUT = 900      # s for each rank process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int = 8) -> None:
    """Run the five legs on ``n_ranks`` gloo CPU ranks (module docstring);
    prints rank 0's lines."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)).rstrip(os.pathsep))
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lk_tpu_torch.parallel.dryrun", str(r),
         str(n_ranks), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(n_ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dry run rank {r} failed (rc "
                               f"{p.returncode}):\n{out[-4000:]}")
    print(outs[0], end="")
    print(f"dry run: {n_ranks} gloo ranks, wall "
          f"{time.perf_counter() - t0:.1f} s")


def _legs(rank: int, world: int) -> None:
    from lk_tpu_torch import entry
    from lk_tpu_torch.config import (DenseLKConfig, LKConfig,
                                     PipelineConfig)
    from lk_tpu_torch.flow.dense import (dense_pyramidal_lk,
                                         dense_pyramidal_lk_multistream)
    from lk_tpu_torch.parallel import (make_mesh, shard_pipeline_step,
                                       sharded_dense_pyramidal_lk,
                                       spatial_dense_lk_level)
    from lk_tpu_torch.parallel.mesh import local_rows
    from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

    say = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_mesh(device_type="cpu")
    n_data, _ = mesh.shape
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    rng = np.random.default_rng(0)       # the same numbers on every rank

    # --- 1. stream data-parallel pipeline step ------------------------------
    w, h = 128, 96
    run_batch, init_batch, shard_frames = shard_pipeline_step(
        mesh, PipelineConfig(), (w, h))
    b, t = n_data * 2, 2
    frames = torch.from_numpy(
        (rng.random((b, t + 1, h, w)) * 255).astype(np.float32))
    states = init_batch(shard_frames(frames[:, 0]))
    states, outs = run_batch(states, shard_frames(frames[:, 1:]))
    assert tuple(outs.show_mask.shape) == (b, t), outs.show_mask.shape
    say(f"data-parallel pipeline step: {b} streams x {t} frames OK")

    # --- 2. spatial dense LK at 1080p, row shards ---------------------------
    rows = make_mesh((world,), ("spatial",), device_type="cpu")
    hh, ww = 1080, 1920
    prev = (rng.random((hh, ww)) * 255).astype(np.float32)
    nxt = (rng.random((hh, ww)) * 255).astype(np.float32)
    mine = local_rows(rows, hh, "spatial")
    fn = spatial_dense_lk_level(rows, LKConfig(), DenseLKConfig(),
                                max_disp=8)
    flow = fn(torch.from_numpy(prev[mine]), torch.from_numpy(nxt[mine]),
              torch.zeros((mine.stop - mine.start, ww, 2)))
    assert tuple(flow.shape) == (mine.stop - mine.start, ww, 2)
    assert bool(torch.isfinite(flow).all())
    say(f"spatial dense LK: {hh}x{ww} over {world} row shards OK "
        "(production 1080p, win 15, 6 iters, disp 8)")

    # --- 3. row-sharded pyramidal solve at 1080p ----------------------------
    a = (rng.random((hh, ww)) * 255).astype(np.float32)
    c = (rng.random((hh, ww)) * 255).astype(np.float32)
    flow = sharded_dense_pyramidal_lk(rows)(torch.from_numpy(a[mine]),
                                            torch.from_numpy(c[mine]))
    ref = dense_pyramidal_lk(torch.from_numpy(a), torch.from_numpy(c)).flow
    err = (flow - ref[mine]).abs().max().reshape(1)
    torch.distributed.all_reduce(err, op=torch.distributed.ReduceOp.MAX)
    assert float(err) == 0, float(err)
    say(f"row-sharded pyramidal dense LK: {hh}x{ww} over {world} shards OK "
        f"(production 1080p full pyramid; bit-equal to the unsharded solve)")

    # --- 4. sharded serving at 860x483 --------------------------------------
    streams = make_mesh((world,), ("streams",), device_type="cpu")
    w_srv, h_srv = 860, 483
    scfg = dataclasses.replace(PipelineConfig(), out_cap=48)
    b_srv, f_srv, chunk = 2 * world, 9, 8
    ms = MultiStreamPipeline(scfg, src_size=(w_srv, h_srv), n_streams=b_srv,
                             chunk=chunk, device="cpu", mesh=streams)
    own = ms.streams
    staging = torch.from_numpy((rng.random((f_srv, b_srv, h_srv, w_srv))
                                * 255).astype(np.uint8)[:, own])
    ms.feed_staged(staging, 0, f_srv)
    ms.drain()
    assert ms.frames_done == ms.n_local * (f_srv - 1), ms.frames_done
    say(f"batched serving step over {world} ranks OK ({b_srv} streams x "
        f"{f_srv - 1} frames @{w_srv}x{h_srv}, feed_staged, chunk {chunk}; "
        f"{ms.n_local} streams per rank)")

    # --- 5. dense stream-DP: the video chain sharded over streams -----------
    n_streams, t_clip, hd, wd = 2 * world, 9, 272, 480
    clips = torch.from_numpy((rng.random((n_streams, t_clip, hd, wd)) * 255)
                             .astype(np.float32))
    sl = local_rows(streams, n_streams, "streams")
    local = dense_pyramidal_lk_multistream(clips[sl], entry.CFG,
                                           entry.DENSE_CFG).flow
    parts = [torch.empty_like(local) for _ in range(world)]
    torch.distributed.all_gather(parts, local.contiguous())
    if rank == 0:
        ref = dense_pyramidal_lk_multistream(clips, entry.CFG,
                                             entry.DENSE_CFG).flow
        diff = float((torch.cat(parts) - ref).abs().max())
        assert diff < DP_TOL, diff
        say(f"dense stream-DP video chain: {n_streams} streams x {t_clip} "
            f"frames @{wd}x{hd} over {world} ranks OK (chunk "
            f"{entry.DENSE_CFG.video_chunk}; parity vs unsharded "
            f"{diff:.1e})")
    torch.distributed.barrier()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port")
    args = ap.parse_args()
    from lk_tpu_torch.parallel.multihost import init_multihost

    torch.set_num_threads(1)
    init_multihost(f"localhost:{args.port}", args.world, args.rank,
                   backend="gloo")
    try:
        _legs(args.rank, args.world)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
