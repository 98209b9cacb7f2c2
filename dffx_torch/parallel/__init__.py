"""dffx_torch.parallel — the process group and the ``(data, spatial)`` mesh.

The port of ``dffx.parallel``.  ``dffx`` is single-controller JAX: its
collectives are compiled from shardings and GSPMD partitions every op.  The
port runs one process per rank (``distributed.initialize``; ``torchrun`` or
``dffx``'s ``--coordinator`` / ``--num_processes`` / ``--process_id``) and
calls its collectives itself:

* ``data`` axis: each rank trains on its rows of the global batch; the train
  step sums the loss's parts, the BatchNorm statistics (``bn_mode="sync"``)
  and the gradients over the axis (``dffx_torch.train.loop``);
* ``spatial`` axis: each rank runs the five kernels' chains on its rows of H
  behind one halo exchange (``dffx_torch.ops.halo``) and the rest of the
  forward whole.
"""

from dffx_torch.parallel import distributed
from dffx_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
    spatial_sharding,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "spatial_sharding",
    "shard_batch",
    "replicate",
    "distributed",
    "Mesh",
    "DATA_AXIS",
    "SPATIAL_AXIS",
]
