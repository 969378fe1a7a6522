"""Max and average pooling over padded neighborhoods (counterpart of
``sph3d_gcn_tpu/ops/pool.py``, ref tf_pool3d_gpu.cu:5-70).

Per output point and channel the max over the valid neighbors, ties
broken toward the first neighbor in k-order (the reference's strict
``>`` at tf_pool3d_gpu.cu:26). The value is re-read through that
neighbor's k slot, so the whole gradient goes to the first maximum, as
the reference's backward scatter does (ties are common in bf16; ``amax``
would split them). ``max_index`` is the input point index of that
maximum, as the reference returns it. Two branches, as in JAX: with
``window`` the per-edge engine's gather (``ops/windowed.py``, K8/K9),
the first max found by the min-encoded ``k * N + idx``; without it the
plain gather and an argmax over k, in chunks of output rows. The average
pool (:func:`avg_pool3d`) takes the same two branches.
"""

from __future__ import annotations

import torch

from sph3d_gcn_torch.ops.gather import gather_features
from sph3d_gcn_torch.ops.windowed import lane_mask, windowed_gather_padded

# byte budget of one chunk's (B, T, K, C) f32 edge block (JAX's
# ops/chunking.py)
_EDGE_CHUNK_BYTES = 32 * 1024 * 1024


def _chunk_size(batch: int, k: int, channels: int, num_out: int) -> int:
    t = _EDGE_CHUNK_BYTES // max(1, 4 * batch * k * channels)
    t = max(8, min(num_out, t))
    if t > 8:
        t = (t // 8) * 8
    return t


def _read_slot(gm: torch.Tensor, k_star: torch.Tensor) -> torch.Tensor:
    """(B, T, K, C) values at the (B, T, C) k slots: the whole gradient
    goes to that slot."""
    return torch.gather(gm, 2, k_star[:, :, None, :]).squeeze(2)


def _max_pool_windowed(inputs, nn_index, nn_count, window, use_kernels):
    num_in = inputs.shape[1]
    num_out, k = nn_index.shape[1], nn_index.shape[2]
    g, valid = windowed_gather_padded(inputs, nn_index, nn_count,
                                      window=window, use_kernels=use_kernels)
    m_pad = g.shape[1]
    idx_p = torch.nn.functional.pad(nn_index, (0, 0, 0, m_pad - num_out))
    gm = torch.where(valid[..., None], g, torch.finfo(g.dtype).min)
    out = gm.amax(dim=2)                                  # (B, M_pad, C)
    is_max = (gm == out[:, :, None, :]) & valid[..., None]
    code = (torch.arange(k, device=g.device)[:, None] * num_in
            + idx_p[..., None]).to(torch.int32)           # (B, M_pad, K, 1)
    enc = torch.where(is_max, code, torch.iinfo(torch.int32).max)
    enc_min = enc.amin(dim=2)
    max_index = (enc_min % num_in).long()
    k_star = (enc_min // num_in).clamp(0, k - 1).long()
    out = _read_slot(gm, k_star)
    return out[:, :num_out], max_index[:, :num_out]


def max_pool3d(
    inputs: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    window: int | None = None,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max pooling over neighborhoods.

    Args:
      inputs:   (B, N, C) float features.
      nn_index: (B, M, K) neighbor indices (M <= N coarse points).
      nn_count: (B, M) valid counts (>= 1).
      window:   the per-edge engine's row window: the gather goes through
        K8 (backward K9). None: the plain gather.

    Returns:
      (output (B, M, C) in the input dtype, max_index (B, M, C) int64: the
      input point index of the first max in k-order).
    """
    if window is not None:
        return _max_pool_windowed(inputs, nn_index, nn_count, window,
                                  use_kernels)
    batch, num_out, k = nn_index.shape
    t = _chunk_size(batch, k, inputs.shape[-1], num_out)
    outs, args = [], []
    for s in range(0, num_out, t):
        idx, cnt = nn_index[:, s:s + t], nn_count[:, s:s + t]
        g = gather_features(inputs, idx)                  # (B, T, K, C)
        gm = torch.where(lane_mask(cnt, k)[..., None], g,
                         torch.finfo(g.dtype).min)
        arg_k = gm.argmax(dim=2)            # first max in k-order
        outs.append(_read_slot(gm, arg_k))
        args.append(torch.gather(idx.long(), 2, arg_k))
    if len(outs) == 1:
        return outs[0], args[0]
    return torch.cat(outs, dim=1), torch.cat(args, dim=1)


def avg_pool3d(
    inputs: torch.Tensor,
    nn_index: torch.Tensor,
    nn_count: torch.Tensor,
    window: int | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Average pooling: each output's mean over its valid neighbors
    (ref tf_pool3d_gpu.cu:53-70), the sum taken in f32 and rounded to the
    input dtype, then scaled by ``1 / max(count, 1)`` computed in the
    input dtype (the JAX op's rounding points).

    Args: as :func:`max_pool3d`; with ``window`` the gather goes through
    K8 and its backward through K9, without it through the plain gather.

    Returns:
      (B, M, C) in the input dtype.
    """
    num_out, k = nn_index.shape[1], nn_index.shape[2]
    dtype = inputs.dtype
    if window is not None:
        g, _ = windowed_gather_padded(inputs, nn_index, nn_count,
                                      window=window, use_kernels=use_kernels)
        cnt = torch.nn.functional.pad(nn_count, (0, g.shape[1] - num_out))
        summed = g.float().sum(dim=2).to(dtype)   # invalid lanes are 0
        inv = 1.0 / torch.clamp_min(cnt, 1).to(dtype)
        return (summed * inv[..., None])[:, :num_out]
    t = _chunk_size(inputs.shape[0], k, inputs.shape[-1], num_out)
    outs = []
    for s in range(0, num_out, t):
        idx, cnt = nn_index[:, s:s + t], nn_count[:, s:s + t]
        g = gather_features(inputs, idx)                  # (B, T, K, C)
        g = torch.where(lane_mask(cnt, k)[..., None], g.float(), 0.0)
        inv = 1.0 / torch.clamp_min(cnt, 1).to(dtype)
        outs.append(g.sum(dim=2).to(dtype) * inv[..., None])
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
