"""Spatial (H-sharded) execution of the kernels' chains over a spatial group.

The port of ``dffx/ops/halo.py``.  Each chain is row-local with a bounded
receptive radius:

* DFFNet's full-resolution chain fm_conv (dilated 9x9, radius 8) -> rb2d (two
  3x3, radius 2) -> attention (pointwise in H and W): radius 10;
* FlowNetwork's ``rb_of_chain``: two 3x3 convs a block, radius 2 a block;
* the full-resolution motion head: four 3x3 convs, radius 4;

so one exchange of ``HALO`` rows with each neighbour makes a rank's rows exact
at every interior cut: a kept row reads only input rows within ``HALO`` of
the shard, and the kernels' own edge handling at the padded shard's ends only
reaches rows that are cropped away.

The true image edges need one correction.  The edge ranks pad with zero rows,
which act as zero pixels; a chain of convs zero-pads every intermediate
instead, and its outputs at the fake rows (BN shifts, windows across the
boundary) bleed into the first ``bleed`` kept rows.  The edge ranks therefore
recompute ``bleed + EDGE_MARGIN`` rows with ``edge_fn``, the chain's stock
layers, on a strip of their own rows (a multiple of 32 that reaches past
those rows by the halo) and patch them in.

``bleed`` is the chain's declared edge-bleed depth and has no default: the
receptive radius of everything after the chain's first conv (the first conv
sees the same zeros either way).  fm chain 2, motion head 3, ``rb_of_chain``
2 a block.  ``dffx`` defaults it to 3, the hazard of a deeper chain
inheriting a constant too small for it; the port asks every caller.

``HALO`` is 16 rows: at least every chain's radius, and with a global H that
divides by ``32 * s`` every shard keeps a height of a multiple of 32 and at
least 32, so the edge strip lies inside the edge rank's own rows.
"""

from __future__ import annotations

import torch

from dffx_torch.parallel import distributed
from dffx_torch.parallel.mesh import SPATIAL_AXIS, spatial_sharding

#: rows exchanged with each neighbour: at least the largest chain radius (10)
HALO = 16
#: rows patched beyond the declared bleed; patching more rows is exact either way
EDGE_MARGIN = 1
H_DIM = 3  # (B, C, N, H, W)


def spatial_active(mesh) -> bool:
    """True when ``mesh`` has a spatial axis of more than one rank."""
    return mesh is not None and mesh.shape.get(SPATIAL_AXIS, 1) > 1


def spatial_ok(mesh, h: int) -> bool:
    """True when a chain of global height ``h`` splits over ``mesh``'s spatial
    axis into shards whose heights are multiples of 32."""
    if not spatial_active(mesh):
        return False
    return h % (32 * mesh.shape[SPATIAL_AXIS]) == 0


def halo_rows(x: torch.Tensor, mesh, halo: int) -> torch.Tensor:
    """``x`` with ``halo`` rows of each neighbour above and below it; zero rows
    at the true image edges."""
    ranks, i = mesh.ranks[SPATIAL_AXIS], mesh.index(SPATIAL_AXIS)
    shape = list(x.shape)
    shape[H_DIM] = halo
    top, bottom = x.new_zeros(shape), x.new_zeros(shape)
    sends, recvs = [], []
    if i > 0:
        sends.append((x[:, :, :, :halo], ranks[i - 1]))
        recvs.append((top, ranks[i - 1]))
    if i < len(ranks) - 1:
        sends.append((x[:, :, :, -halo:], ranks[i + 1]))
        recvs.append((bottom, ranks[i + 1]))
    distributed.exchange(sends, recvs, mesh.group(SPATIAL_AXIS))
    return torch.cat([top, x, bottom], dim=H_DIM)


def halo_sharded_chain(fn, x: torch.Tensor, mesh, *, edge_fn, halo: int = HALO,
                       bleed: int) -> torch.Tensor:
    """``fn`` — a row-local chain ``(B, C, N, H, W) -> (B, C', N, H, W)`` with
    zero-pad edges and a receptive radius of at most ``halo`` — on this
    rank's H-shard ``x`` of a global height that divides by ``32 * s``.

    One exchange of ``halo`` rows with each spatial neighbour (zero rows at the
    true edges), ``fn`` on the padded shard, a crop back to the shard; on the
    first and last rank of the axis the outer ``bleed + EDGE_MARGIN`` rows come
    from ``edge_fn`` (the chain with exact zero padding) on a strip of
    ``ceil((bleed + EDGE_MARGIN + halo) / 32) * 32`` of the rank's rows.
    Returns this rank's rows of the output."""
    s = mesh.shape[SPATIAL_AXIS] if mesh is not None else 1
    if s == 1:
        return fn(x)
    h = x.shape[H_DIM]
    assert h % 32 == 0, (tuple(x.shape), s)
    out = fn(halo_rows(x, mesh, halo)).narrow(H_DIM, halo, h)
    edge_rows = bleed + EDGE_MARGIN
    strip = -(-(edge_rows + halo) // 32) * 32
    assert edge_rows < strip <= h, (strip, edge_rows, h)
    i = mesh.index(SPATIAL_AXIS)
    if i in (0, s - 1):
        out = out.clone()
    if i == 0:
        out[:, :, :, :edge_rows] = edge_fn(x[:, :, :, :strip])[:, :, :, :edge_rows]
    if i == s - 1:
        out[:, :, :, h - edge_rows:] = edge_fn(x[:, :, :, h - strip:])[:, :, :, strip - edge_rows:]
    return out


def sharded_rows(fn, x: torch.Tensor, mesh, *, edge_fn, bleed: int) -> torch.Tensor:
    """``fn(x)`` for a whole ``x`` held by every rank of the spatial axis: each
    rank cuts its rows, runs ``halo_sharded_chain`` on them, and one
    all-gather along H rebuilds the whole output on every rank."""
    rows = spatial_sharding(mesh, x.shape[H_DIM])
    local = x[:, :, :, rows].contiguous()
    y = halo_sharded_chain(fn, local, mesh, edge_fn=edge_fn, bleed=bleed)
    return distributed.all_gather_cat(y.contiguous(), H_DIM, mesh.group(SPATIAL_AXIS))
