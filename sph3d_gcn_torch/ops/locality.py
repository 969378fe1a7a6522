"""Spatial locality: per-cloud axis sorting (counterpart of
``sph3d_gcn_tpu/ops/locality.py``).

Each cloud is sorted along the one axis that minimises the worst
2*radius slab occupancy (a 128-bin histogram estimate), so every in-range
neighbor of a query lies in a contiguous row window. Sorting is a pure
input permutation; order-dependent semantics (first-K selection, the FPS
seed) then apply to the sorted order, as in the JAX package.
"""

from __future__ import annotations

import torch

_HIST_BINS = 128


def choose_sort_axis(xyz: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, N, 3) coordinates -> (B,) int32 axis ids in {0, 1, 2}."""
    xyz = xyz.float()
    mins = xyz.amin(dim=1, keepdim=True)                  # (B, 1, 3)
    maxs = xyz.amax(dim=1, keepdim=True)
    extent = torch.clamp_min(maxs - mins, 1e-12)
    bins = ((xyz - mins) / extent * _HIST_BINS).to(torch.int64)
    bins = bins.clamp(0, _HIST_BINS - 1).transpose(1, 2)  # (B, 3, N)
    hist = torch.zeros(
        bins.shape[:2] + (_HIST_BINS,), dtype=torch.int64, device=xyz.device
    ).scatter_add_(2, bins, torch.ones_like(bins))        # (B, 3, HIST)
    width = torch.ceil(
        2.0 * radius / (extent[:, 0, :] / _HIST_BINS)
    ).to(torch.int64) + 1                                  # (B, 3)
    width = width.clamp(1, _HIST_BINS)
    csum = torch.nn.functional.pad(torch.cumsum(hist, dim=-1), (1, 0))
    starts = torch.arange(_HIST_BINS, device=xyz.device)
    ends = torch.clamp_max(starts + width[..., None], _HIST_BINS)
    win = torch.gather(csum, 2, ends) - csum[..., :-1]
    occ = win.amax(dim=-1)                                 # (B, 3)
    return torch.argmin(occ, dim=-1).to(torch.int32)


def spatial_sort(
    xyz: torch.Tensor, radius: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cloud stable axis argsort.

    Returns (perm, rank), both (B, N) int64: sorted row j holds original
    point perm[j]; original point i lands at sorted row rank[i]."""
    coords = xyz[..., :3].float()
    axis = choose_sort_axis(coords, radius).to(torch.int64)
    key = torch.gather(
        coords, 2, axis[:, None, None].expand(-1, coords.shape[1], 1)
    )[..., 0]
    perm = torch.argsort(key, dim=1, stable=True)
    return perm, invert_permutation(perm)


def sort_indices_small(idx: torch.Tensor) -> torch.Tensor:
    """Ascending stable sort of (B, S) index arrays."""
    return torch.sort(idx, dim=1, stable=True).values


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation -> its inverse."""
    iota = torch.arange(perm.shape[-1], device=perm.device, dtype=perm.dtype)
    return torch.empty_like(perm).scatter_(
        1, perm, iota.expand_as(perm).contiguous()
    )


def permute_points(x: torch.Tensor, perm: torch.Tensor,
                   inv: torch.Tensor | None = None) -> torch.Tensor:
    """Reorder the point axis: (B, N, ...) x (B, N) -> (B, N, ...).

    With ``inv`` (the inverse permutation) the backward is a gather by
    ``inv`` (the JAX op's custom VJP): a permutation's transpose is a
    permutation, where autograd of the gather would scatter-add (float
    atomics on a CUDA device)."""
    if inv is None:
        return _take_rows(x, perm)
    return _Permute.apply(x, perm, inv)


def _take_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    idx = perm.to(torch.int64).reshape(perm.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(perm.shape + x.shape[2:]))


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return _take_rows(x, perm)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return _take_rows(grad, inv), None, None
