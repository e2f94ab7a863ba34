"""Device meshes over ``torch.distributed`` ranks: counterpart of
``lk_tpu.parallel.mesh``.

One process per device: a mesh is a ``DeviceMesh`` over the ranks of the
default process group (``init_process_group`` first; ``parallel.multihost``
wraps it), on ``cuda`` unless the caller names the CPU.  The two axes are
``data`` (independent streams, no collective) and ``spatial`` (row shards
of one frame, neighbour halo exchange)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "spatial"),
              devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over ``devices`` (global ranks; default every rank of the
    world, in rank order); by default it splits them data x spatial.

    With n ranks and no shape given: spatial gets 2 when n is even and
    > 2 (halo exchange needs a ring), data gets the rest.  Every rank of
    the world calls it (the mesh builds one process group per axis)."""
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if shape is None:
        shape = default_shape(n)
    assert math.prod(shape) == n, (shape, n)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def default_shape(n: int) -> Tuple[int, int]:
    """(data, spatial) for n ranks: spatial 2 when n is even and > 2."""
    spatial = 2 if (n % 2 == 0 and n > 2) else 1
    return n // spatial, spatial


def stream_sharding(mesh: DeviceMesh, axis: str = "data") -> list:
    """Placements of a stream-batched tensor: its leading dim sharded over
    ``axis``, replicated over the mesh's other axes (the DTensor
    counterpart of ``NamedSharding(mesh, P(axis))``)."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def local_rows(mesh: DeviceMesh, n: int, axis: str) -> slice:
    """The rows of an n-row leading dim that this rank holds when the dim
    is sharded evenly over ``axis``."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows not divisible by mesh axis {axis!r} "
                         f"size {size}")
    per = n // size
    at = mesh.get_local_rank(axis)
    return slice(at * per, (at + 1) * per)


def rank_device(device_type: str) -> torch.device:
    """This process's device of the mesh's type: the CPU, or the CUDA
    device made current for it (``multihost.init_multihost``)."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)
