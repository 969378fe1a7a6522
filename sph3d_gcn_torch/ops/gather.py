"""Neighbor-feature gather (counterpart of ``sph3d_gcn_tpu/ops/gather.py``).

Every per-edge op gathers ``(B, N, C) x (B, M, K) -> (B, M, K, C)``. The
JAX package gives its gather a custom VJP, a deterministic XLA
scatter-add (``segment_scatter_add``), because autodiff's scatter is slow
on the TPU. Here the gather is ``torch.gather`` and its backward
PyTorch's own scatter-add, which runs a deterministic implementation on a
CUDA device under ``torch.use_deterministic_algorithms(True)`` (and is
sequential, hence reproducible, on the CPU). The windowed engine's
gather, which carries the level convs and pools, is the hand-written
kernel pair of ``ops/windowed.py``; this one serves the global conv and
the ``window=None`` (f32 parity) branches.
"""

from __future__ import annotations

import torch


def gather_features(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, K) -> (B, M, K, C); also (B, M) index shapes,
    returning (B, M, C)."""
    b, c = idx.shape[0], feats.shape[-1]
    flat = idx.long().reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(feats, 1, flat).reshape(idx.shape + (c,))
