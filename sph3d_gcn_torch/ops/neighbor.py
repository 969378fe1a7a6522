"""Sphere and cube range queries keeping the first K in point order
(counterpart of ``build_sphere_neighbor``,
``build_sphere_neighbor_and_bins`` and ``build_cube_neighbor`` in
``sph3d_gcn_tpu/ops/neighbor.py``).

Reproduced quirks (ref tf_nnquery_gpu.cu):
- strict ``dist < radius`` with an extra ``|dist - radius| > 1e-6``
  margin (:49), distances from the matmul form ``|q|^2 - 2 q.db + |db|^2``
  as the JAX op computes its in-range mask;
- the stored distance is ``sqrt(euclidean)`` from the difference form (:54);
- ``count = min(total_in_range, K)`` (:56-62);
- a query with no neighbor in range grows its radius by +0.05 until it
  has one (:30-60), up to the JAX op's 512 steps, unless
  ``self_graph=True`` says every query is in the database (a self graph
  never grows: each query finds itself).

The query runs over tiles of queries whose (B, T, N) f32 distance block
fits 128 MiB, as the JAX op's ``_query_tile_size`` cuts them, and picks
the first K in-range points of each row by a cumulative count of the
in-range mask and a binary search for the counts 1..K (no sort of whole
rows). Plain PyTorch: the JAX op is XLA, not a Pallas kernel. The grown
radius is found without a loop: the in-range test is monotone in the
radius and in the distance, so a row's radius is the first of the f32
running sums ``r, r + 0.05, ...`` (the JAX loop's own rounding) at which
its nearest point is in range; no host synchronisation.

``dilation_rate`` scales the radius (the cube's edge) as a Python float
product, ``float(dilation_rate) * float(radius)`` (ref
tf_nnquery.py:30-31), so the f32 threshold is the JAX op's; the scaled
radius then serves the in-range test, the growth and the bins' radial
split alike.

The cube query (ref tf_nnquery_gpu.cu:75-108) keeps the first K points
with ``|delta| < length/2`` on every axis, strictly, and bins each by
its cell of a ``gridsize``^3 grid over the cube; no growth, no
distances. It tiles its queries so that one (B, T, N, 3) f32
displacement block stays within the plain dense ops' element budget.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sph3d_gcn_torch.ops.dense import _PLAIN_BUDGET
from sph3d_gcn_torch.ops.kernelbin import bins_from_delta, validate_kernel_size
from sph3d_gcn_torch.ops.types import CubeNeighborhood, Neighborhood

_BOUNDARY_EPS = 1e-6
_GROW_STEP = 0.05                 # ref tf_nnquery_gpu.cu:59
_MAX_GROW_ITERS = 512             # the JAX op's bound on the growth loop
_TILE_BYTES = 128 * 1024 * 1024   # one (B, T, N) f32 distance block


def _query_tile_size(batch: int, num_db: int, num_query: int) -> int:
    """The JAX op's query-tile size: a (B, T, N) f32 block within the
    byte budget, a multiple of 8 unless tiny."""
    t = _TILE_BYTES // max(1, 4 * batch * num_db)
    t = max(8, min(num_query, t))
    if t > 8:
        t = (t // 8) * 8
    return t


def _in_range(d: torch.Tensor, r) -> torch.Tensor:
    """The reference's strict ``<`` with the 1e-6 boundary margin."""
    return (d < r) & ((d - r).abs() > _BOUNDARY_EPS)


@functools.lru_cache(maxsize=None)
def _grown_radii(radius: float) -> np.ndarray:
    """The growth loop's radii: ``r_0 = f32(radius)``, ``r_{i+1} =
    f32(r_i + f32(0.05))`` for the loop's 512 steps."""
    radii = [np.float32(radius)]
    for _ in range(_MAX_GROW_ITERS):
        radii.append(np.float32(radii[-1] + np.float32(_GROW_STEP)))
    radii = np.array(radii, np.float32)
    radii.setflags(write=False)
    return radii


def _dilated(radius: float, dilation_rate: float | None) -> float:
    """The reference's radius (or cube edge) times ``dilation_rate``, in
    Python floats."""
    if dilation_rate is None:
        return float(radius)
    return float(dilation_rate) * float(radius)


def _first_in_order(mask: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., N) bool -> (idx (..., k) int64 of the first k True columns in
    order, 0 past the total; valid (..., k) bool; total (...) int32)."""
    csum = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    targets = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    # the t-th True column is the first column whose running count is t
    idx = torch.searchsorted(csum, targets.expand(csum.shape[:-1] + (k,))
                             .contiguous())
    total = csum[..., -1]
    valid = targets <= total[..., None]
    idx = torch.where(valid, idx.clamp_max(mask.shape[-1] - 1), 0)
    return idx, valid, total


def _first_k(q: torch.Tensor, db: torch.Tensor, radius: float,
             k: int, self_graph: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 3) queries x (B, N, 3) database -> (idx (B, T, K) int64 of
    the first K in-range points in point order, 0 past the count; count
    (B, T) int64 = min(in-range total, K)). Without ``self_graph`` a row
    with no point in range takes the first grown radius at which its
    nearest point is in range (the JAX op's growth loop)."""
    cross = torch.einsum("btc,bnc->btn", q, db)
    d2 = (q * q).sum(-1, keepdim=True) - 2.0 * cross + (db * db).sum(-1)[
        :, None, :
    ]
    d = torch.sqrt(torch.clamp_min(d2, 0.0))                  # (B, T, N)
    if self_graph:
        mask = _in_range(d, radius)
    else:
        radii = torch.from_numpy(_grown_radii(radius).copy()).to(d.device)
        steps = (~_in_range(d.amin(dim=-1, keepdim=True), radii)).sum(-1)
        r = radii[steps.clamp_max(_MAX_GROW_ITERS)]           # (B, T)
        mask = _in_range(d, r[..., None])
    idx, _, total = _first_in_order(mask, k)
    return idx, torch.clamp_max(total, k).long()


def _sphere_query(database: torch.Tensor, query: torch.Tensor,
                  radius: float, nn_sample: int, self_graph: bool
                  ) -> tuple[Neighborhood, torch.Tensor]:
    """The query and its displacements: (Neighborhood with K = nn_sample,
    delta (B, M, k, 3) f32 of the k = min(nn_sample, N) searched lanes)."""
    db = database[..., :3].float()
    q = query[..., :3].float()
    batch, num_db, _ = db.shape
    num_q = q.shape[1]
    k = min(int(nn_sample), num_db)
    t = _query_tile_size(batch, num_db, num_q)
    parts = [_first_k(q[:, s:s + t], db, float(radius), k, self_graph)
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
    dilation_rate: float | None = None,
    self_graph: bool = False,
) -> Neighborhood:
    """(B, N, 3+) database, (B, M, 3+) queries -> Neighborhood with
    (B, M, K) idx/dist and (B, M) count; padding entries are 0.
    ``dilation_rate`` scales the radius; ``self_graph``: every query is a
    database point (no radius growth)."""
    nbh, _ = _sphere_query(database, query, _dilated(radius, dilation_rate),
                           nn_sample, self_graph)
    return nbh


def build_sphere_neighbor_and_bins(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float,
    nn_sample: int,
    kernel: tuple[int, int, int] = (8, 2, 2),
    dilation_rate: float | None = None,
    self_graph: bool = False,
) -> tuple[Neighborhood, torch.Tensor]:
    """The query plus the spherical kernel bins of its edges from the same
    gathered displacements: equal to ``build_sphere_neighbor`` followed by
    ``ops.kernelbin.spherical_kernel`` (both at the dilated radius).
    Returns (Neighborhood, (B, M, K) int64 bins, 0 = self loop and
    padding)."""
    validate_kernel_size(kernel)
    radius = _dilated(radius, dilation_rate)
    nbh, delta = _sphere_query(database, query, radius, nn_sample,
                               self_graph)
    k = delta.shape[2]
    bins = bins_from_delta(delta, nbh.dist[..., :k], nbh.count, radius,
                           kernel)
    pad = int(nn_sample) - k
    if pad:
        bins = torch.nn.functional.pad(bins, (0, pad))
    return nbh, bins


def build_cube_neighbor(
    database: torch.Tensor,
    query: torch.Tensor,
    length: float = 0.1,
    nn_sample: int = 100,
    gridsize: int = 3,
    dilation_rate: float | None = None,
) -> CubeNeighborhood:
    """Axis-aligned cube query with its grid bins: (B, N, 3+) database,
    (B, M, 3+) queries -> CubeNeighborhood with (B, M, K) idx and bin (bin
    ``xId*g^2 + yId*g + zId``, ``Id = clip(int((delta + length/2) /
    (length/g)), 0, g-1)``) and (B, M) count clamped to K; padding
    entries are 0. ``dilation_rate`` scales ``length``."""
    db = database[..., :3].float()
    q = query[..., :3].float()
    length = _dilated(length, dilation_rate)
    half = length / 2.0
    cell = length / float(gridsize)
    batch, num_db, _ = db.shape
    k = int(nn_sample)
    # one (B, T, N, 3) displacement block within the plain ops' budget
    t = max(1, _PLAIN_BUDGET // max(1, 3 * batch * num_db))
    parts = []
    for s in range(0, q.shape[1], t):
        delta = db[:, None, :, :] - q[:, s:s + t, None, :]   # (B, T, N, 3)
        inside = (delta.abs() < half).all(dim=-1)
        idx, valid, total = _first_in_order(inside, k)
        d_sel = torch.gather(delta, 2, idx[..., None].expand(-1, -1, -1, 3))
        cells = ((d_sel + half) / cell).to(torch.int64).clamp(0, gridsize - 1)
        bins = (cells[..., 0] * gridsize * gridsize
                + cells[..., 1] * gridsize + cells[..., 2])
        parts.append((idx, torch.where(valid, bins, 0),
                      torch.clamp_max(total, k).long()))
    return CubeNeighborhood(*(torch.cat(p, dim=1) for p in zip(*parts)))
