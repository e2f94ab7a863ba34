"""Stream data-parallelism: independent videos over the ``data`` axis.
Counterpart of ``lk_tpu.parallel.streams``.

Each stream's state and frame chunk shard on their leading dim; streams
never talk to each other, so each rank runs the single-stream chunk runner
(``pipeline.runner.make_chunk_runner``) on the B/D streams it holds, with
no collective: lk_tpu vmaps the per-stream runner, the port loops over its
local streams and stacks the results.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from lk_tpu_torch.config import PipelineConfig
from lk_tpu_torch.parallel.mesh import local_rows, rank_device, stream_sharding
from lk_tpu_torch.pipeline.runner import make_chunk_runner


def tree_map(fn, *trees):
    """fn over the tensor leaves of same-shaped (nested) NamedTuples."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensor leaves of (nested) NamedTuples, in field order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def shard_pipeline_step(mesh: DeviceMesh, cfg: PipelineConfig,
                        frame_size: Tuple[int, int], axis: str = "data"):
    """Returns (run_batch, init_batch, shard_frames) for stream-sharded
    batches on this rank's device of the mesh's type.

    run_batch(states, frames (B, T, H, W)) -> (states, outputs), B sharded
    over ``axis``; init_batch(first frames (B, H, W)) -> states.  Inputs are
    DTensors (or this rank's local shards), results DTensors sharded the
    same way.  shard_frames(frames): the global batch, identical on every
    rank, as that DTensor (no communication)."""
    device = rank_device(mesh.device_type)
    run_chunk, init_fn, _masks = make_chunk_runner(cfg, frame_size, device)
    placements = stream_sharding(mesh, axis)

    def to_global(tree):
        return tree_map(lambda x: DTensor.from_local(
            x, mesh, placements, run_check=False), tree)

    def stack(trees):
        return tree_map(lambda *xs: torch.stack(xs), *trees)

    def init_batch(first) -> object:
        first = _local(first)
        return to_global(stack([init_fn(f) for f in first]))

    def run_batch(states, frames):
        states, frames = tree_map(_local, states), _local(frames)
        results = [run_chunk(tree_map(lambda x, b=b: x[b], states),
                             frames[b]) for b in range(frames.shape[0])]
        return (to_global(stack([s for s, _ in results])),
                to_global(stack([o for _, o in results])))

    def shard_frames(frames: torch.Tensor) -> DTensor:
        rows = local_rows(mesh, frames.shape[0], axis)
        return DTensor.from_local(frames[rows].to(device), mesh, placements,
                                  run_check=False)

    return run_batch, init_batch, shard_frames
