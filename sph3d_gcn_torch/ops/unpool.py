"""Graph unpooling of the per-edge engine: the mean and the weighted
interpolation (counterpart of ``sph3d_gcn_tpu/ops/unpool.py``, ref
tf_unpool3d_gpu.cu:5-22,45-63).

Each fine point's feature comes from its coarse neighbors, the inter
graph of ``nn.graph.build_graph_deconv`` (fine queries, coarse indices):

- mean: the masked mean over the valid neighbors, the same function as
  the avg pool (``ops.pool.avg_pool3d``; the JAX package's two bodies are
  identical);
- weighted: the sum of the neighbors' features times given per-edge
  weights (the scene models pass weights proportional to the distance,
  ``nn.layers.unpool3d``).

Two branches, as in JAX: with ``window`` the per-edge engine's gather
(``ops/windowed.py``: K8 forward, K9 backward), the sum over K in torch;
without it the plain gather, in chunks of output rows.
"""

from __future__ import annotations

import torch

from sph3d_gcn_torch.ops.gather import gather_features
from sph3d_gcn_torch.ops.pool import _chunk_size, avg_pool3d
from sph3d_gcn_torch.ops.windowed import (
    _pad_rows,
    lane_mask,
    windowed_gather_padded,
)


def mean_interpolate(
    inputs: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    window: int | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Fine-point feature = the mean of its valid coarse neighbors.

    Args:
      inputs:   (B, N, C) coarse features.
      nn_index: (B, M, K) coarse-neighbor indices of each fine point.
      nn_count: (B, M) valid counts.
      window:   the per-edge engine's row window: the gather goes through
        K8 (backward K9). None: the plain gather.

    Returns:
      (B, M, C) in the input dtype (the sum in f32, rounded, then scaled
      by ``1 / max(count, 1)`` in the input dtype, as the JAX op rounds).
    """
    return avg_pool3d(inputs, nn_index, nn_count, window=window,
                      use_kernels=use_kernels)


def weighted_interpolate(
    inputs: torch.Tensor,
    weight: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    window: int | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Fine-point feature = the weighted sum of its valid coarse neighbors
    (ref tf_unpool3d_gpu.cu:45-63).

    Args:
      inputs, nn_index, nn_count, window: as :func:`mean_interpolate`.
      weight:   (B, M, K) f32 per-edge weights; invalid lanes' weights are
        zeroed before the product, so a K8 zero never meets a non-finite
        weight.

    Returns:
      (B, M, C). With ``window``: in the input dtype, the weights rounded
      to it before the product, the sum in f32 and rounded once. Without:
      the product in the promoted dtype of features and weights (f32 for
      f32 weights), as the JAX op computes it.
    """
    num_out, k = nn_index.shape[1], nn_index.shape[2]
    if window is not None:
        g, valid = windowed_gather_padded(inputs, nn_index, nn_count,
                                          window=window,
                                          use_kernels=use_kernels)
        w = torch.where(valid, _pad_rows(weight, g.shape[1]), 0.0)
        prod = g * w.to(inputs.dtype)[..., None]
        out = torch.sum(prod, dim=2, dtype=torch.float32).to(inputs.dtype)
        return out[:, :num_out]
    t = _chunk_size(inputs.shape[0], k, inputs.shape[-1], num_out)
    outs = []
    for s in range(0, num_out, t):
        idx, cnt = nn_index[:, s:s + t], nn_count[:, s:s + t]
        w = torch.where(lane_mask(cnt, k), weight[:, s:s + t], 0.0)
        outs.append((gather_features(inputs, idx) * w[..., None]).sum(dim=2))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
