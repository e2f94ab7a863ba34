"""Multi-host scale-out over ``torch.distributed``: counterpart of
``lk_tpu.parallel.multihost``.

One process per device.  Streams (the ``data`` axis) spread over hosts
with no collective in the step, so the slow inter-host fabric carries no
traffic and each host decodes only the streams it owns
(``process_stream_slice``); the ``spatial`` axis, whose halo exchanges
ride neighbour sends, stays inside a host.  ``global_stream_mesh`` keeps
``data`` outermost (consecutive ranks, so whole hosts under torchrun's
rank order) and ``spatial`` innermost.

With no arguments ``init_multihost`` reads torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), the counterpart of ``jax.distributed``'s cluster
auto-detection; a manual cluster (and the two-process CPU test,
tests/test_torch_multihost.py) passes the coordinator's ``host:port``,
the process count and this process's rank.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from lk_tpu_torch.parallel.mesh import axis_size, make_mesh


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join this process to the default process group over ``tcp://``.

    ``backend`` defaults to NCCL when this process has a card and gloo
    when it runs on the CPU.  With a card, the process's device is made
    current first: ``LOCAL_RANK`` under torchrun, else the rank modulo the
    card count."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    on_card = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if on_card:
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_stream_mesh(spatial: int = 1,
                       axis_names: Sequence[str] = ("data", "spatial"),
                       device_type: str = "cuda") -> DeviceMesh:
    """Global mesh over every rank of every process: ``data`` outermost
    (consecutive ranks), ``spatial`` innermost."""
    n = dist.get_world_size()
    assert n % spatial == 0, (n, spatial)
    return make_mesh((n // spatial, spatial), axis_names,
                     device_type=device_type)


def process_stream_slice(mesh: DeviceMesh, n_streams: int,
                         axis: str = "data") -> slice:
    """Which rows of the global stream batch THIS process must produce:
    the ``axis`` shards all of whose ranks are this process.  When the
    other axes span processes (spatial > 1 with one process per device),
    no shard is this process's alone, and every process feeds all rows."""
    size = axis_size(mesh, axis)
    assert n_streams % size == 0, (n_streams, size)
    per_shard = n_streams // size
    at = mesh.mesh_dim_names.index(axis)
    shards = mesh.mesh.movedim(at, 0).reshape(size, -1)
    me = dist.get_rank()
    mine = [i for i, ranks in enumerate(shards.tolist())
            if all(r == me for r in ranks)]
    if not mine:
        return slice(0, n_streams)
    lo, hi = mine[0], mine[-1] + 1
    assert mine == list(range(lo, hi)), "data shards must be contiguous"
    return slice(lo * per_shard, hi * per_shard)


def host_local_to_global(x: torch.Tensor, mesh: DeviceMesh,
                         placements: Sequence) -> DTensor:
    """Lift this process's shard (its ``process_stream_slice`` rows) into
    the global tensor the sharded step consumes (no communication)."""
    return DTensor.from_local(x, mesh, list(placements), run_check=False)


def global_to_host_local(x: DTensor, mesh: DeviceMesh,
                         placements: Sequence) -> torch.Tensor:
    """Inverse of :func:`host_local_to_global` for draining outputs: this
    process's shard of ``x``, which lies on ``mesh`` with ``placements``."""
    if x.device_mesh != mesh or tuple(x.placements) != tuple(placements):
        raise ValueError(f"{x.placements} on {x.device_mesh}, expected "
                         f"{tuple(placements)} on {mesh}")
    return x.to_local()


def read_replicated(x: DTensor) -> np.ndarray:
    """Host value of a fully replicated global tensor (this rank's copy)."""
    if not all(isinstance(p, Replicate) for p in x.placements):
        raise ValueError(f"not replicated: {x.placements}")
    return x.to_local().cpu().numpy()
