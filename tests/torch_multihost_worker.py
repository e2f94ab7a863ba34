"""Worker process of the 2-process multi-host test (test_torch_multihost.py).

Runs the stream-sharded VP pipeline chunk of lk_tpu_torch on a global mesh
over two OS processes (gloo on the CPU, one rank each -> data axis of 2),
each process feeding only its own stream rows, then checks its local
output shard against a locally computed single-process baseline.  Imports
no jax.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(1)

from lk_tpu_torch.config import PipelineConfig  # noqa: E402
from lk_tpu_torch.parallel.multihost import (  # noqa: E402
    global_stream_mesh, global_to_host_local, host_local_to_global,
    init_multihost, process_stream_slice, read_replicated)
from lk_tpu_torch.parallel.mesh import stream_sharding  # noqa: E402
from lk_tpu_torch.parallel.streams import (shard_pipeline_step,  # noqa: E402
                                           tree_leaves, tree_map)
from lk_tpu_torch.pipeline.runner import make_chunk_runner  # noqa: E402


def main():
    pid, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_multihost(f"localhost:{port}", num_processes=n, process_id=pid)
    assert torch.distributed.get_world_size() == n
    assert torch.distributed.get_backend() == "gloo"
    mesh = global_stream_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (n, 1), mesh

    cfg = PipelineConfig()
    w, h, b, t = 256, 144, 8, 3
    rng = np.random.default_rng(0)  # the same frames in every process
    frames = torch.from_numpy(
        (rng.random((b, t + 1, h, w)) * 255).astype(np.float32))

    # single-process baseline: every stream, no mesh
    run_chunk, init_fn, _ = make_chunk_runner(cfg, (w, h), "cpu")
    base = [run_chunk(init_fn(fr[0]), fr[1:])[1] for fr in frames]

    # global run: this process feeds only the stream rows it owns
    rows = process_stream_slice(mesh, b)
    spec = stream_sharding(mesh)
    run_batch, init_batch, _ = shard_pipeline_step(mesh, cfg, (w, h))
    g_first = host_local_to_global(frames[rows, 0], mesh, spec)
    g_frames = host_local_to_global(frames[rows, 1:], mesh, spec)
    assert tuple(g_first.shape) == (b, h, w)
    states = init_batch(g_first)
    states, outs = run_batch(states, g_frames)
    local = tree_map(lambda x: global_to_host_local(x, mesh, spec), outs)

    for i, ours in enumerate(tree_leaves(local)):
        ref = np.stack([tree_leaves(o)[i].numpy() for o in base])[rows]
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # a replicated value reads back the same on every host
    from torch.distributed.tensor import Replicate

    total = host_local_to_global(torch.tensor([float(b)]), mesh,
                                 [Replicate()] * mesh.ndim)
    assert read_replicated(total)[0] == b
    print(f"MULTIHOST_OK {pid} rows={rows.start}:{rows.stop}", flush=True)


if __name__ == "__main__":
    main()
