"""Sphere range query keeping the first K in point order (counterpart of
``build_sphere_neighbor`` and ``build_sphere_neighbor_and_bins`` in
``sph3d_gcn_tpu/ops/neighbor.py``).

Reproduced quirks (ref tf_nnquery_gpu.cu):
- strict ``dist < radius`` with an extra ``|dist - radius| > 1e-6``
  margin (:49), distances from the matmul form ``|q|^2 - 2 q.db + |db|^2``
  as the JAX op computes its in-range mask;
- the stored distance is ``sqrt(euclidean)`` from the difference form (:54);
- ``count = min(total_in_range, K)`` (:56-62).

The query runs over tiles of queries whose (B, T, N) f32 distance block
fits 128 MiB, as the JAX op's ``_query_tile_size`` cuts them, and picks
the first K in-range points of each row by a cumulative count of the
in-range mask and a binary search for the counts 1..K (no sort of whole
rows). Plain PyTorch: the JAX op is XLA, not a Pallas kernel. The
reference's radius growth for zero-neighbor queries (:30-60) is not
ported: such a query keeps count 0, as the JAX op's ``self_graph=True``
form gives. Every query of a self graph (the level graphs) finds itself,
and the global graph (radius 100) finds every point.
"""

from __future__ import annotations

import torch

from sph3d_gcn_torch.ops.kernelbin import bins_from_delta, validate_kernel_size
from sph3d_gcn_torch.ops.types import Neighborhood

_BOUNDARY_EPS = 1e-6
_TILE_BYTES = 128 * 1024 * 1024   # one (B, T, N) f32 distance block


def _query_tile_size(batch: int, num_db: int, num_query: int) -> int:
    """The JAX op's query-tile size: a (B, T, N) f32 block within the
    byte budget, a multiple of 8 unless tiny."""
    t = _TILE_BYTES // max(1, 4 * batch * num_db)
    t = max(8, min(num_query, t))
    if t > 8:
        t = (t // 8) * 8
    return t


def _first_k(q: torch.Tensor, db: torch.Tensor, radius: float,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 3) queries x (B, N, 3) database -> (idx (B, T, K) int64 of
    the first K in-range points in point order, 0 past the count; count
    (B, T) int64 = min(in-range total, K))."""
    cross = torch.einsum("btc,bnc->btn", q, db)
    d2 = (q * q).sum(-1, keepdim=True) - 2.0 * cross + (db * db).sum(-1)[
        :, None, :
    ]
    d = torch.sqrt(torch.clamp_min(d2, 0.0))                  # (B, T, N)
    mask = (d < radius) & ((d - radius).abs() > _BOUNDARY_EPS)
    csum = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=q.device)
    # the t-th in-range point is the first column whose running count is t
    idx = torch.searchsorted(csum, targets.expand(csum.shape[:-1] + (k,))
                             .contiguous())
    total = csum[..., -1]
    valid = targets <= total[..., None]
    idx = torch.where(valid, idx.clamp_max(db.shape[1] - 1), 0)
    return idx, torch.clamp_max(total, k).long()


def _sphere_query(database: torch.Tensor, query: torch.Tensor,
                  radius: float, nn_sample: int
                  ) -> tuple[Neighborhood, torch.Tensor]:
    """The query and its displacements: (Neighborhood with K = nn_sample,
    delta (B, M, k, 3) f32 of the k = min(nn_sample, N) searched lanes)."""
    db = database[..., :3].float()
    q = query[..., :3].float()
    batch, num_db, _ = db.shape
    num_q = q.shape[1]
    k = min(int(nn_sample), num_db)
    t = _query_tile_size(batch, num_db, num_q)
    parts = [_first_k(q[:, s:s + t], db, float(radius), k)
             for s in range(0, num_q, t)]
    idx = torch.cat([p[0] for p in parts], dim=1)
    count = torch.cat([p[1] for p in parts], dim=1)
    sel = torch.gather(
        db, 1, idx.reshape(batch, -1, 1).expand(-1, -1, 3)
    ).reshape(idx.shape + (3,))
    delta = sel - q[:, :, None, :]
    dx, dy, dz = delta.unbind(-1)
    d3 = torch.sqrt(dx * dx + dy * dy + dz * dz)
    valid = torch.arange(k, device=d3.device) < count[..., None]
    nn_dist = torch.where(valid, torch.sqrt(d3), 0.0)
    pad = int(nn_sample) - k
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        nn_dist = torch.nn.functional.pad(nn_dist, (0, pad))
    return Neighborhood(idx, count, nn_dist), delta


def build_sphere_neighbor(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float = 0.1,
    nn_sample: int = 100,
) -> Neighborhood:
    """(B, N, 3+) database, (B, M, 3+) queries -> Neighborhood with
    (B, M, K) idx/dist and (B, M) count; padding entries are 0."""
    nbh, _ = _sphere_query(database, query, radius, nn_sample)
    return nbh


def build_sphere_neighbor_and_bins(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float,
    nn_sample: int,
    kernel: tuple[int, int, int] = (8, 2, 2),
) -> tuple[Neighborhood, torch.Tensor]:
    """The query plus the spherical kernel bins of its edges from the same
    gathered displacements: equal to ``build_sphere_neighbor`` followed by
    ``ops.kernelbin.spherical_kernel``. Returns (Neighborhood, (B, M, K)
    int64 bins, 0 = self loop and padding)."""
    validate_kernel_size(kernel)
    nbh, delta = _sphere_query(database, query, radius, nn_sample)
    k = delta.shape[2]
    bins = bins_from_delta(delta, nbh.dist[..., :k], nbh.count, radius,
                           kernel)
    pad = int(nn_sample) - k
    if pad:
        bins = torch.nn.functional.pad(bins, (0, pad))
    return nbh, bins
