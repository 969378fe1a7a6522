"""Spherical kernel bin assignment (counterpart of
``sph3d_gcn_tpu/ops/kernelbin.py``, ref tf_buildkernel_gpu.cu:20-78).

Each (query, neighbor) displacement falls into one of ``n*p*q + 1`` bins:
azimuth ``atan2(dy, dx)`` folded into [0, 2pi), elevation
``atan2(dz, dist2d)`` folded into [0, pi], radial from the sqrt-space
``nn_dist``; bin 0 is the self loop (``nn_dist <= 1.01e-3`` with the
1e-6 margin). Plain PyTorch: it serves ModelNet's global conv and, through
:func:`bins_from_delta`, the per-edge engine's fused query.
"""

from __future__ import annotations

import math

import torch

from sph3d_gcn_torch.ops.types import Neighborhood

_M_EPS = 1.01e-3
_EPS = 1e-6


def validate_kernel_size(kernel: tuple[int, int, int]) -> None:
    """Reference attr checks: n>2 even, p>0 even, q>0."""
    n, p, q = kernel
    if not (n > 2 and n % 2 == 0):
        raise ValueError(f"azimuth bins n must be even and > 2, got {n}")
    if not (p > 0 and p % 2 == 0):
        raise ValueError(f"elevation bins p must be even and > 0, got {p}")
    if not q > 0:
        raise ValueError(f"radial bins q must be > 0, got {q}")


def spherical_kernel(
    database: torch.Tensor,
    query: torch.Tensor,
    neighborhood: Neighborhood,
    radius: float,
    kernel: tuple[int, int, int] = (8, 2, 3),
) -> torch.Tensor:
    """(B, M, K) int64 bin ids in [0, n*p*q]; padding entries are 0."""
    validate_kernel_size(kernel)
    db = database[..., :3].float()
    q = query[..., :3].float()
    idx, count, dist = neighborhood
    b, m, k = idx.shape
    gathered = torch.gather(
        db, 1, idx.long().reshape(b, m * k, 1).expand(-1, -1, 3)
    ).reshape(b, m, k, 3)
    return bins_from_delta(gathered - q[:, :, None, :], dist, count, radius,
                           kernel)


def bins_from_delta(
    delta: torch.Tensor,
    dist: torch.Tensor,
    count: torch.Tensor,
    radius: float,
    kernel: tuple[int, int, int],
) -> torch.Tensor:
    """Bins of (B, M, K, 3) neighbor displacements with their sqrt-space
    ``dist`` (B, M, K); lanes at or past ``count`` get 0."""
    n_bins, p_bins, q_bins = kernel
    dx, dy, dz = delta.unbind(-1)
    dist2d = torch.sqrt(dx * dx + dy * dy)
    pi = math.pi
    theta = torch.atan2(dy, dx)
    theta = torch.where(theta < pi, theta, -pi)
    theta = torch.clamp_min(theta, -pi) + pi
    phi = torch.atan2(dz, dist2d).clamp(-pi / 2, pi / 2) + pi / 2
    alpha = theta * n_bins / 2.0 / pi
    beta = phi * p_bins / pi
    gamma = dist * q_bins / (radius + 1e-6)
    n_id = torch.clamp_max(alpha.to(torch.int64), n_bins - 1)
    p_id = torch.clamp_max(beta.to(torch.int64), p_bins - 1)
    q_id = torch.clamp_max(gamma.to(torch.int64), q_bins - 1)
    bins = q_id * p_bins * n_bins + p_id * n_bins + n_id + 1
    is_far = (dist > _M_EPS) & ((dist - _M_EPS).abs() > _EPS)
    k_ids = torch.arange(delta.shape[2], device=delta.device)
    valid = k_ids < count[..., None]
    return torch.where(is_far & valid, bins, 0)
