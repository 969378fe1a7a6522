"""Depthwise spherical graph convolution on edge lists (counterpart of the
plain-gather branch of ``sph3d_gcn_tpu/ops/conv.py``).

    out[b, m, c*r + j] = sum_k in[b, nn[m,k], c] * filt[bin[m,k], c, j] / cnt[m]

(ref tf_conv3d_gpu.cu:20-27). Neighbor features are summed per bin first
(one-hot contraction, f32), scaled by the inverse count, cast to the
compute dtype and contracted with the filter — the JAX op's rounding
points. The dense engine (``ops/dense.py``) carries the level convs; this
op serves ModelNet's global conv.
"""

from __future__ import annotations

import torch


def einsum_f32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 operands and f32 accumulation: the counterpart
    of ``jnp.einsum(..., preferred_element_type=jnp.float32)`` on bf16 or
    f32 inputs (bf16 widens to f32 exactly). Callers set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
    for full f32 products on CUDA."""
    return torch.einsum(equation, *(o.float() for o in operands))


def depthwise_conv3d(
    inputs: torch.Tensor,
    filt: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    bin_index: torch.Tensor,
) -> torch.Tensor:
    """Depthwise graph convolution with per-bin filters and neighbor mean.

    Args:
      inputs:    (B, N, C) float features (the compute dtype).
      filt:      (F, C, r) filter.
      nn_index:  (B, M, K) neighbor indices.
      nn_count:  (B, M) valid-neighbor counts.
      bin_index: (B, M, K) filter-bin ids in [0, F).

    Returns:
      (B, M, C*r) in the input dtype.
    """
    batch, _, c_in = inputs.shape
    num_out, k = nn_index.shape[1], nn_index.shape[2]
    f_bins, _, mult = filt.shape
    dtype = inputs.dtype
    idx = nn_index.long().reshape(batch, num_out * k, 1).expand(-1, -1, c_in)
    g = torch.gather(inputs, 1, idx).reshape(batch, num_out, k, c_in)
    k_ids = torch.arange(k, device=inputs.device)
    valid = k_ids < nn_count[..., None]                       # (B, M, K)
    onehot = (bin_index.long()[..., None]
              == torch.arange(f_bins, device=inputs.device))
    onehot = onehot & valid[..., None]
    s = einsum_f32("btkf,btkc->btfc", onehot, g)
    inv_cnt = 1.0 / torch.clamp_min(nn_count, 1).float()
    s = s * inv_cnt[..., None, None]
    out = einsum_f32("btfc,fcr->btcr", s.to(dtype), filt.to(dtype))
    return out.reshape(batch, num_out, c_in * mult).to(dtype)
