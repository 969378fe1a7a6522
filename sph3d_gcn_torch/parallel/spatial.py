"""Point-axis sharding of the dense windowed engine (counterpart of
``sph3d_gcn_tpu/parallel/spatial.py``).

The P ranks of a :class:`parallel.PointGroup` hold contiguous 128-row
chunks of each axis-sorted cloud, and every rank computes its own query
tiles. The dense engine proves per 128-query tile that all of the
tile's candidate rows lie in one W-row slab from ``s_blk``, so a rank
needs only a bounded halo of feature rows from its ring neighbours,
exchanged point to point (:func:`halo_exchange`), and the dense kernels
(conv both ways, rank pool, masked means) run unchanged on the haloed
block with ``s_blk`` rebased into its coordinates
(:func:`local_neighborhood`). JAX runs this inside ``shard_map`` over the
devices of one process; here each rank is a process.

Safety follows the engine's certificate: :func:`local_neighborhood`
returns ``shard_ok``, True iff every rebased window fit inside the halo;
windows are clamped into bounds so an out-of-halo step stays defined,
and the models fold it into ``dense_ok`` and report it as ``halo_ok``
(``train.loop.fit`` re-runs a halo-only breach at twice the inter-level
halos, then on the classic engine).

The exchanges: on an NCCL group one ``dist.batch_isend_irecv`` of every
hop's slabs; on a gloo group, whose send and receive take CPU tensors
only, the slabs go through host buffers (chosen by the group's backend).
Each function that carries a gradient is a ``torch.autograd.Function``
with its transpose as the backward: :func:`halo_exchange` and
:func:`halo_reduce` are each other's, :func:`all_rows`'s sums the
cotangent over the point ranks and keeps this rank's rows, and
:func:`psum_replicated`'s is the identity (a summed value that every
rank then uses once).
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from sph3d_gcn_torch.ops.dense import DenseNeighborhood
from sph3d_gcn_torch.ops.query import TILE
from sph3d_gcn_torch.parallel.mesh import DataGroup, PointGroup, spread

__all__ = [
    "all_rows",
    "halo_exchange",
    "halo_reduce",
    "halo_stats",
    "local_neighborhood",
    "localize_tiles",
    "pad_count_for_sharding",
    "psum_replicated",
    "reset_halo_stats",
    "shardable_rows",
    "slice_rows_local",
]

# what this process's exchanges moved since reset_halo_stats: slabs sent,
# their rows (summed over the batch) and bytes, and the host seconds the
# exchanges took (staging and waits included)
_STATS = {"exchanges": 0, "rows": 0, "bytes": 0, "seconds": 0.0}


def halo_stats() -> dict:
    """A copy of the exchange counters (module ``_STATS``)."""
    return dict(_STATS)


def reset_halo_stats() -> None:
    _STATS.update(exchanges=0, rows=0, bytes=0, seconds=0.0)


def _exchange(points: PointGroup, sends: list[tuple[torch.Tensor, int]]
              ) -> list[torch.Tensor]:
    """Non-periodic ring shifts, all at once: for each ``(slab, hop)``
    this rank sends ``slab`` to point rank ``rank + hop`` and receives the
    slab that ``rank - hop`` sent (zeros where no such rank exists)."""
    t0 = time.perf_counter()
    staged = points.backend != "nccl"
    sends = [(slab.contiguous(), hop) for slab, hop in sends]
    recvs = [torch.zeros_like(slab, device="cpu" if staged else None)
             for slab, _ in sends]
    ops = []
    for (slab, hop), recv in zip(sends, recvs):
        dst, src = points.rank + hop, points.rank - hop
        if 0 <= dst < points.size:
            ops.append((dist.isend, slab.cpu() if staged else slab,
                        points.ranks[dst]))
            _STATS["rows"] += slab.shape[0] * slab.shape[1]
            _STATS["bytes"] += slab.numel() * slab.element_size()
        if 0 <= src < points.size:
            ops.append((dist.irecv, recv, points.ranks[src]))
    if staged:
        works = [op(t, peer, group=points.group) for op, t, peer in ops]
    else:
        works = dist.batch_isend_irecv([
            dist.P2POp(op, t, peer, group=points.group)
            for op, t, peer in ops])
    for w in works:
        w.wait()
    if staged:
        recvs = [r.to(slab.device) for r, (slab, _) in zip(recvs, sends)]
    _STATS["exchanges"] += 1
    _STATS["seconds"] += time.perf_counter() - t0
    return recvs


def _halo_exchange(x: torch.Tensor, halo: int, points: PointGroup
                   ) -> torch.Tensor:
    if halo == 0:
        return x
    n_local = x.shape[1]
    hops = -(-halo // n_local)
    sends = []
    for h in range(1, hops + 1):
        take = min(n_local, halo - (h - 1) * n_local)
        # left halo, hop h: the tail of the rank h to the left; right
        # halo: the head of the rank h to the right
        sends += [(x[:, n_local - take:], h), (x[:, :take], -h)]
    got = _exchange(points, sends)
    left = [got[2 * (h - 1)] for h in range(hops, 0, -1)]
    right = [got[2 * (h - 1) + 1] for h in range(1, hops + 1)]
    return torch.cat(left + [x] + right, dim=1)


def _halo_reduce(x: torch.Tensor, halo: int, points: PointGroup
                 ) -> torch.Tensor:
    if halo == 0:
        return x
    n_local = x.shape[1] - 2 * halo
    if n_local <= 0:
        raise ValueError(f"{x.shape[1]} rows hold no shard within a halo "
                         f"of {halo}")
    hops = -(-halo // n_local)
    sends, takes = [], []
    off = halo
    for h in range(1, hops + 1):
        take = min(n_local, halo - (h - 1) * n_local)
        off -= take
        r0 = halo + n_local + (h - 1) * n_local
        # rows held for the owner h to the left go back to it; those
        # held for the owner h to the right likewise
        sends += [(x[:, off:off + take], -h), (x[:, r0:r0 + take], h)]
        takes.append(take)
    got = _exchange(points, sends)
    out = x[:, halo:halo + n_local].clone()
    for h, take in enumerate(takes):
        out[:, n_local - take:] += got[2 * h]
        out[:, :take] += got[2 * h + 1]
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, points):
        ctx.halo, ctx.points = halo, points
        return _halo_exchange(x, halo, points)

    @staticmethod
    def backward(ctx, ct):
        return _halo_reduce(ct, ctx.halo, ctx.points), None, None


class _HaloReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, points):
        ctx.halo, ctx.points = halo, points
        return _halo_reduce(x, halo, points)

    @staticmethod
    def backward(ctx, ct):
        return _halo_exchange(ct, ctx.halo, ctx.points), None, None


def halo_exchange(x: torch.Tensor, halo: int, points: PointGroup
                  ) -> torch.Tensor:
    """(B, n_local, ...) rows -> (B, halo + n_local + halo, ...).

    Rows [0, halo) are the tails of the ranks to the left, the last
    ``halo`` rows the heads of the ranks to the right; the edge ranks see
    zeros (the padding the dense ops already mask: padded window slots
    hold ``packed == 0``). A halo wider than the shard comes in
    ``ceil(halo / n_local)`` hops, hop h from the rank at distance h.
    Its gradient is :func:`halo_reduce` of the cotangent."""
    return _HaloExchange.apply(x, int(halo), points)


def halo_reduce(x: torch.Tensor, halo: int, points: PointGroup
                ) -> torch.Tensor:
    """The transpose of :func:`halo_exchange`: the halo rows of a
    (B, halo + n_local + halo, ...) block are summed back into the ranks
    that own them; returns this rank's (B, n_local, ...) sums. Its
    gradient is :func:`halo_exchange` of the cotangent."""
    return _HaloReduce.apply(x, int(halo), points)


def pad_count_for_sharding(dnbh: DenseNeighborhood, num_shards: int
                           ) -> DenseNeighborhood:
    """The count row padded to the tile grid (``num_query`` = the padded
    row count), so that the count and the tiles split alike over
    ``num_shards`` ranks. Raises when the tiles do not split."""
    n_t = dnbh.s_blk.shape[1]
    if n_t % num_shards:
        raise ValueError(
            f"{n_t} query tiles not divisible by {num_shards} shards; "
            "pad the cloud (configs round num_input) or change the mesh")
    m_pad = n_t * TILE
    count = F.pad(dnbh.count, (0, m_pad - dnbh.count.shape[1]))
    return dataclasses.replace(dnbh, count=count, num_query=m_pad)


def local_neighborhood(dnbh: DenseNeighborhood, rank: int,
                       halo_blocks: int, n_local_blocks: int
                       ) -> tuple[DenseNeighborhood, torch.Tensor]:
    """Rebase the windows of point rank ``rank``'s tiles (``dnbh``, with
    ``s_blk`` in the whole database's blocks) into the haloed block of
    ``n_local_blocks + 2 * halo_blocks`` TILE blocks that
    :func:`halo_exchange` (``halo = halo_blocks * TILE``) gives it.

    Returns the local neighborhood, its ``s_blk`` clamped into the block
    and ``ok`` folded with ``shard_ok``, and ``shard_ok``: True iff no
    window needed the clamp, i.e. each lay inside the halo. One window of
    halo always covers an intra-level self graph (a tile's window starts
    at or before its own rows); inter-level graphs are calibrated."""
    w_blocks = dnbh.window // TILE
    s_local = dnbh.s_blk - rank * n_local_blocks + halo_blocks
    hi = n_local_blocks + 2 * halo_blocks - w_blocks
    shard_ok = ((s_local >= 0) & (s_local <= hi)).all()
    local = dataclasses.replace(dnbh, s_blk=s_local.clamp(0, hi),
                                ok=dnbh.ok & shard_ok)
    return local, shard_ok


def shardable_rows(num_rows: int, num_shards: int) -> bool:
    """True when ``num_rows`` rows split into equal, TILE-aligned,
    non-empty chunks of whole tiles over ``num_shards`` ranks. Levels that
    fail (the coarse tails of a pyramid) run replicated: they carry a
    small share of the work, which concentrates at the fine levels."""
    n_t = num_rows // TILE
    return num_rows % TILE == 0 and n_t % num_shards == 0 \
        and n_t >= num_shards


def slice_rows_local(x: torch.Tensor, points: DataGroup) -> torch.Tensor:
    """(B, N, ...) replicated -> this rank's contiguous (B, N/P, ...)
    rows."""
    n_local = x.shape[1] // points.size
    return x[:, points.rank * n_local:(points.rank + 1) * n_local]


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *groups):
        y = x.clone()
        for group in groups:
            if spread(group):
                group.all_reduce_(y)
        return y

    @staticmethod
    def backward(ctx, ct):
        return (ct,) + (None,) * len(ctx.needs_input_grad[1:])


def psum_replicated(x: torch.Tensor, *groups: DataGroup | None
                    ) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``groups`` (each None or of one
    rank adds nothing), whose backward is the identity: the sum is ONE
    value that each rank then uses, so each rank's own cotangent is the
    true one (a sum's own transpose, another sum, would scale it by the
    ranks; JAX's docstring records that factor)."""
    return _PsumReplicated.apply(x, *groups)


class _AllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, points):
        ctx.points = points
        parts = [torch.empty_like(x) for _ in range(points.size)]
        dist.all_gather(parts, x.contiguous(), group=points.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, ct):
        ct = ct.contiguous().clone()
        ctx.points.all_reduce_(ct)
        return slice_rows_local(ct, ctx.points), None


def all_rows(x: torch.Tensor, points: PointGroup) -> torch.Tensor:
    """(B, N/P, ...) rows -> the replicated (B, N, ...) cloud, in point
    order. The backward sums the cotangent over the point ranks and
    keeps this rank's rows: the gathered cloud is one value that every
    rank uses (JAX's ``all_gather`` transposes a factor P too large)."""
    return _AllRows.apply(x, points)


def localize_tiles(dnbh: DenseNeighborhood, rank: int, shards: int,
                   halo_blocks: int | None,
                   db_blocks_local: int | None = None
                   ) -> tuple[DenseNeighborhood, torch.Tensor]:
    """Point rank ``rank``'s chunk of the query tiles of a replicated
    neighborhood, its windows rebased when the database rows are sharded
    too. ``halo_blocks`` None keeps them (the database stays
    replicated); otherwise the op takes ``halo_exchange(local_rows,
    halo_blocks * TILE)`` and ``db_blocks_local`` is the rank's own row
    extent in TILE blocks (:func:`local_neighborhood`)."""
    n_t = dnbh.s_blk.shape[1]
    if n_t % shards:
        raise ValueError(f"{n_t} query tiles do not split over {shards} "
                         "shards")
    ntl = n_t // shards
    sl = slice(rank * ntl, (rank + 1) * ntl)
    count = F.pad(dnbh.count, (0, n_t * TILE - dnbh.count.shape[1]))
    local = dataclasses.replace(
        dnbh, packed=dnbh.packed[:, sl], s_blk=dnbh.s_blk[:, sl],
        dist=None if dnbh.dist is None else dnbh.dist[:, sl],
        count=count[:, rank * ntl * TILE:(rank + 1) * ntl * TILE],
        num_query=ntl * TILE)
    if halo_blocks is None:
        return local, torch.ones((), dtype=torch.bool,
                                 device=dnbh.s_blk.device)
    if db_blocks_local is None:
        raise ValueError("db_blocks_local names the rank's own rows")
    return local_neighborhood(local, rank, halo_blocks, db_blocks_local)
