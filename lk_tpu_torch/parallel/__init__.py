"""Multi-device scaling over ``torch.distributed``: meshes, stream
data-parallelism, spatial sharding.  Counterpart of ``lk_tpu.parallel``.

One process per device (NCCL on the card, gloo on the CPU).  Scale comes
from two orthogonal mesh axes:

* ``data``: independent dashcam streams (no cross-stream communication);
* ``spatial``: row shards of large frames for the dense flow path, with
  halo exchange between ring neighbours.

Tensor, pipeline and expert parallelism have no counterpart in this
workload (there are no weight matrices to shard).
"""

from lk_tpu_torch.parallel.auto import sharded_dense_pyramidal_lk  # noqa: F401
from lk_tpu_torch.parallel.mesh import make_mesh, stream_sharding  # noqa: F401
from lk_tpu_torch.parallel.spatial import (  # noqa: F401
    halo_exchange,
    spatial_dense_lk_level,
)
from lk_tpu_torch.parallel.streams import shard_pipeline_step  # noqa: F401
