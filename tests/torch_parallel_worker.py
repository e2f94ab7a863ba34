"""One rank of tests/test_torch_parallel.py's gloo CPU groups.

Reads the legs' inputs from <dir>/inputs.npz (written by the test, so the
ranks and lk_tpu see the same numbers), runs each leg named on the command
line through lk_tpu_torch.parallel and writes this rank's results to
<dir>/rank<r>.npz (arrays) and <dir>/rank<r>.json (sink rows).  Imports no
jax: the ranks run the port only.

Usage: python torch_parallel_worker.py <rank> <world> <port> <dir> <leg>...
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(1)

from lk_tpu_torch.config import DenseLKConfig, LKConfig  # noqa: E402
from lk_tpu_torch.parallel import (halo_exchange, make_mesh,  # noqa: E402
                                   shard_pipeline_step,
                                   sharded_dense_pyramidal_lk,
                                   spatial_dense_lk_level)
from lk_tpu_torch.parallel.mesh import local_rows  # noqa: E402
from lk_tpu_torch.parallel.multihost import init_multihost  # noqa: E402

# the spatial legs: (exchange_per_iter, use_pallas_fused)
SPATIAL_MODES = ((False, False), (True, False), (False, True), (True, True))


def rows_of(mesh, x, axis="spatial"):
    return torch.from_numpy(np.ascontiguousarray(
        x[local_rows(mesh, x.shape[0], axis)]))


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    legs = sys.argv[5:]
    init_multihost(f"localhost:{port}", world, rank, backend="gloo")
    inp = np.load(os.path.join(out, "inputs.npz"))
    res, rows = {}, {}
    spatial = make_mesh((1, world), device_type="cpu")
    res["mesh_shape"] = np.asarray(make_mesh(device_type="cpu").shape)
    if "halo" in legs:
        group = spatial.get_group("spatial")
        res["halo"] = halo_exchange(rows_of(spatial, inp["halo_x"]), 2,
                                    group).numpy()
    for leg in ("spatial", "seam"):
        if leg not in legs:
            continue
        prev, nxt, flow = (rows_of(spatial, inp[f"{leg}_{k}"])
                           for k in ("prev", "next", "flow"))
        for per_iter, fused in SPATIAL_MODES:
            if fused and leg == "seam":
                continue
            fn = spatial_dense_lk_level(
                spatial, LKConfig(), DenseLKConfig(use_pallas_fused=fused),
                max_disp=8, exchange_per_iter=per_iter)
            res[f"{leg}_{int(per_iter)}{int(fused)}"] = fn(
                prev, nxt, flow).numpy()
    if "auto" in legs:
        run = sharded_dense_pyramidal_lk(spatial)
        res["auto"] = run(rows_of(spatial, inp["auto_prev"]),
                          rows_of(spatial, inp["auto_next"])).numpy()
    if "streams" in legs:
        from lk_tpu_torch.config import PipelineConfig

        data = make_mesh((world, 1), device_type="cpu")
        h, w = inp["streams_frames"].shape[-2:]
        run_batch, init_batch, shard_frames = shard_pipeline_step(
            data, PipelineConfig(), (w, h))
        for scene in ("streams", "road"):
            frames = torch.from_numpy(inp[f"{scene}_frames"])
            states = init_batch(shard_frames(frames[:, 0]))
            _, outs = run_batch(states, shard_frames(frames[:, 1:]))
            for k, leaf in zip(outs._fields, outs):
                res[f"{scene}_{k}"] = leaf.to_local().numpy()
    if "serving" in legs:
        import dataclasses

        from lk_tpu_torch.models import PRESETS
        from lk_tpu_torch.pipeline.runner import MultiStreamPipeline

        streams = make_mesh((world,), ("streams",), device_type="cpu")
        u8 = torch.from_numpy(inp["serving_u8"])
        f, b, h, w = u8.shape
        cfg = dataclasses.replace(PRESETS["final"], width=w, out_cap=48)
        ms = MultiStreamPipeline(cfg, src_size=(w, h), n_streams=b,
                                 chunk=8, device="cpu", mesh=streams)
        u8 = u8[:, ms.streams]                  # this rank's streams only
        t = 0
        while t < f:
            n = min(8 + (1 if ms.states is None else 0), f - t)
            ms.feed_staged(u8, t, n)
            t += n
        ms.drain()
        rows["serving"] = {
            "streams": [ms.streams.start, ms.streams.stop],
            "pipes": [dict(frames_done=p.frames_done, csv_rows=p.csv_rows,
                           cross_points=p.cross_points,
                           vp_per_frame=p.vp_per_frame) for p in ms.pipes]}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(rows, fh)
    print(f"RANK_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
