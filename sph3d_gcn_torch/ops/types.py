"""Fixed-degree padded neighborhoods (counterpart of
``sph3d_gcn_tpu/ops/types.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Neighborhood(NamedTuple):
    """A padded fixed-degree neighborhood graph.

    Attributes:
      idx:   (B, M, K) int64 database-point index of each query's k-th
             neighbor; entries with ``k >= count`` are padding (0).
      count: (B, M) int64 valid neighbors, clamped to K.
      dist:  (B, M, K) float32 sqrt-space distance ``sqrt(euclidean)``
             (ref tf_nnquery_gpu.cu:54); padding entries are 0.
    """

    idx: torch.Tensor
    count: torch.Tensor
    dist: torch.Tensor | None = None


class CubeNeighborhood(NamedTuple):
    """A cube query's result: neighbor indices with their grid bins
    (``BuildCubeNeighbor``'s (point index, bin index) pairs, ref
    tf_nnquery_gpu.cu:96-108).

    Attributes:
      idx:   (B, M, K) int64 database-point index of each query's k-th
             neighbor; padding (0) past the count.
      bin:   (B, M, K) int64 grid bin in [0, gridsize**3); padding 0.
      count: (B, M) int64 valid neighbors, clamped to K.
    """

    idx: torch.Tensor
    bin: torch.Tensor
    count: torch.Tensor
