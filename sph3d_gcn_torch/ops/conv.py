"""Depthwise spherical graph convolution on edge lists (counterpart of
``sph3d_gcn_tpu/ops/conv.py``).

    out[b, m, c*r + j] = sum_k in[b, nn[m,k], c] * filt[bin[m,k], c, j] / cnt[m]

(ref tf_conv3d_gpu.cu:20-27). Neighbor features are summed per bin first
(one-hot contraction, f32), scaled by the inverse count, cast to the
compute dtype and contracted with the filter — the JAX op's rounding
points. Two branches, as in JAX: with ``window`` the per-edge engine's
gather (``ops/windowed.py``, kernels K8/K9) over tile-padded rows; without
it the plain gather, in chunks of output rows (the f32 parity path and
ModelNet's global conv).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sph3d_gcn_torch.ops.gather import gather_features
from sph3d_gcn_torch.ops.windowed import (
    EdgeLists,
    lane_mask,
    windowed_gather_padded,
)

# byte budget of one chunk's (B, T, K, max(C, F)) f32 transients (JAX's)
_CHUNK_BYTES = 64 * 1024 * 1024


def einsum_f32(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``einsum`` with f32 operands and f32 accumulation: the counterpart
    of ``jnp.einsum(..., preferred_element_type=jnp.float32)`` on bf16 or
    f32 inputs (bf16 widens to f32 exactly). Callers set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)
    for full f32 products on CUDA."""
    return torch.einsum(equation, *(o.float() for o in operands))


def _chunk_size(batch: int, k: int, width: int, num_out: int) -> int:
    """Output rows per chunk of the plain branch (JAX's rule)."""
    t = _CHUNK_BYTES // max(1, 4 * batch * k * width)
    t = max(8, min(num_out, t))
    if t > 8:
        t = (t // 8) * 8
    return t


def _bin_conv(g, valid, bins, cnt, filt, dtype):
    """Per-bin sums of the gathered (B, T, K, C) features, mean, filter:
    (B, T, C*r) in ``dtype``."""
    f_bins, c_in, mult = filt.shape
    onehot = bins.long()[..., None] == torch.arange(f_bins, device=g.device)
    s = einsum_f32("btkf,btkc->btfc", onehot & valid[..., None], g)
    s = s * (1.0 / torch.clamp_min(cnt, 1).float())[..., None, None]
    out = einsum_f32("btfc,fcr->btcr", s.to(dtype), filt.to(dtype))
    return out.reshape(g.shape[0], g.shape[1], c_in * mult).to(dtype)


def depthwise_conv3d(
    inputs: torch.Tensor,
    filt: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    bin_index: torch.Tensor,
    window: int | None = None,
    lists: EdgeLists | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Depthwise graph convolution with per-bin filters and neighbor mean.

    Args:
      inputs:    (B, N, C) float features (the compute dtype).
      filt:      (F, C, r) filter.
      nn_index:  (B, M, K) neighbor indices.
      nn_count:  (B, M) valid-neighbor counts.
      bin_index: (B, M, K) filter-bin ids in [0, F).
      window:    the per-edge engine's row window (JAX's ``window``): the
        edge gather goes through K8 (backward K9). None: the plain gather.
      lists:     the windowed gather's :class:`EdgeLists` of this
        neighborhood, shared with other convs through it (None: its own).
      use_kernels: the kernels' dispatch rule (``_build.use_kernel``).

    Returns:
      (B, M, C*r) in the input dtype.
    """
    dtype = inputs.dtype
    batch, _, c_in = inputs.shape
    num_out, k = nn_index.shape[1], nn_index.shape[2]
    if window is not None:
        g, valid = windowed_gather_padded(inputs, nn_index, nn_count,
                                          window=window, lists=lists,
                                          use_kernels=use_kernels)
        m_pad = g.shape[1]
        pad = (0, m_pad - num_out)
        out = _bin_conv(g, valid, F.pad(bin_index, (0, 0) + pad),
                        F.pad(nn_count, pad), filt, dtype)
        return out[:, :num_out]
    t = _chunk_size(batch, k, max(c_in, filt.shape[0]), num_out)
    outs = []
    for s in range(0, num_out, t):
        idx, cnt = nn_index[:, s:s + t], nn_count[:, s:s + t]
        outs.append(_bin_conv(gather_features(inputs, idx),
                              lane_mask(cnt, k), bin_index[:, s:s + t], cnt,
                              filt, dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
