"""The ``(data, spatial)`` mesh over the ranks of the process group.

Axis conventions follow ``dffx/parallel/mesh.py``: ``data`` shards the batch,
``spatial`` shards H.  Rank r sits at ``(r // spatial, r % spatial)``, as
``dffx`` lays its devices out (``reshape(data, spatial)``).  A JAX mesh is
a set of devices the compiler partitions over; here it is a small record of
this rank's place and one process group per axis, which the port's code
hands to its collectives.  Without a process group (one process) the mesh
has one rank and no group, and nothing runs a collective.

The sharding helpers keep ``dffx``'s names: ``batch_sharding`` and
``spatial_sharding`` are this rank's contiguous rows of the batch and of H,
``shard_batch`` cuts them out of a host batch, and ``replicate`` broadcasts
tensors from rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dffx_torch.parallel import distributed

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``spatial`` ranks; this rank's coordinates; per axis the
    global ranks of this rank's group along it and the group (``None``
    without a process group)."""

    data: int
    spatial: int
    rank: int
    ranks: Dict[str, Tuple[int, ...]]
    groups: Dict[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, SPATIAL_AXIS: self.spatial}

    @property
    def size(self) -> int:
        return self.data * self.spatial

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.ranks[axis].index(self.rank)

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(*, data: Optional[int] = None, spatial: int = 1) -> Mesh:
    """A ``(data, spatial)`` mesh over every rank of the process group (one
    rank without one).  Defaults to all ranks on ``data`` (pure data
    parallelism, the train recipes' only scaling axis).  Every rank must call
    it, with the same arguments: each creates every axis group, as
    ``dist.new_group`` asks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        assert n % spatial == 0, (n, spatial)
        data = n // spatial
    assert data * spatial == n, (data, spatial, n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(data, spatial)
    axes = {DATA_AXIS: [tuple(int(r) for r in grid[:, j]) for j in range(spatial)],
            SPATIAL_AXIS: [tuple(int(r) for r in grid[i]) for i in range(data)]}
    ranks, groups = {}, {}
    for axis, lines in axes.items():
        for line in lines:
            group = dist.new_group(list(line)) if dist.is_initialized() else None
            if rank in line:
                ranks[axis], groups[axis] = line, group
    return Mesh(data, spatial, rank, ranks, groups)


def _rows(mesh: Mesh, axis: str, n: int) -> slice:
    size = mesh.shape[axis]
    assert n % size == 0, (n, axis, size)
    local = n // size
    i = mesh.index(axis)
    return slice(i * local, (i + 1) * local)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's contiguous rows of a batch of ``batch_size`` over ``data``."""
    return _rows(mesh, DATA_AXIS, batch_size)


def spatial_sharding(mesh: Mesh, height: int) -> slice:
    """This rank's contiguous rows of an image of ``height`` over ``spatial``."""
    return _rows(mesh, SPATIAL_AXIS, height)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """This rank's rows of every leaf of a global host batch, on ``device``."""
    return distributed.global_batch(
        {k: np.asarray(v)[batch_sharding(mesh, len(v))] for k, v in batch.items()}, device)


def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast each tensor from rank 0 into every rank's, in place (over the
    whole process group; nothing without one)."""
    if not dist.is_initialized():
        return
    for t in tensors:
        distributed.broadcast_(t, 0)
