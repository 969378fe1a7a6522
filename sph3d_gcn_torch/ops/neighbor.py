"""Sphere range query keeping the first K in point order (counterpart of
``build_sphere_neighbor`` in ``sph3d_gcn_tpu/ops/neighbor.py``).

Reproduced quirks (ref tf_nnquery_gpu.cu):
- strict ``dist < radius`` with an extra ``|dist - radius| > 1e-6``
  margin (:49), distances from the matmul form ``|q|^2 - 2 q.db + |db|^2``
  as the JAX op computes its in-range mask;
- the stored distance is ``sqrt(euclidean)`` from the difference form (:54);
- ``count = min(total_in_range, K)`` (:56-62).

Plain PyTorch, for ModelNet's global graph (every point to the centroid
at radius 100), which always finds neighbors. The reference's radius
growth for zero-neighbor queries (:30-60) is not ported: such a query
keeps count 0, as the JAX op's ``self_graph=True`` form gives. It comes
with the classic per-edge engine.
"""

from __future__ import annotations

import torch

from sph3d_gcn_torch.ops.types import Neighborhood

_BOUNDARY_EPS = 1e-6


def build_sphere_neighbor(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float = 0.1,
    nn_sample: int = 100,
) -> Neighborhood:
    """(B, N, 3+) database, (B, M, 3+) queries -> Neighborhood with
    (B, M, K) idx/dist and (B, M) count; padding entries are 0."""
    db = database[..., :3].float()
    q = query[..., :3].float()
    num_db = db.shape[1]
    k = min(int(nn_sample), num_db)
    cross = torch.einsum("btc,bnc->btn", q, db)
    d2 = (q * q).sum(-1, keepdim=True) - 2.0 * cross + (db * db).sum(-1)[
        :, None, :
    ]
    d = torch.sqrt(torch.clamp_min(d2, 0.0))                  # (B, M, N)
    r = float(radius)
    mask = (d < r) & ((d - r).abs() > _BOUNDARY_EPS)
    # in-range points first, each group in point order
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    idx = order[..., :k]
    count = torch.clamp_max(mask.sum(dim=-1), k)
    valid = torch.arange(k, device=d.device) < count[..., None]
    idx = torch.where(valid, idx, 0)
    sel = torch.gather(
        db, 1, idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, 3)
    ).reshape(idx.shape + (3,))
    delta = sel - q[:, :, None, :]
    dx, dy, dz = delta.unbind(-1)
    d3 = torch.sqrt(dx * dx + dy * dy + dz * dz)
    nn_dist = torch.where(valid, torch.sqrt(d3), 0.0)
    pad = int(nn_sample) - k
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        nn_dist = torch.nn.functional.pad(nn_dist, (0, pad))
    return Neighborhood(idx, count, nn_dist)
