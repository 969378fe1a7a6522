"""Farthest-point sampling (counterpart of ``sph3d_gcn_tpu/ops/sample.py``
and its Pallas kernel ``ops/pallas/fps_kernel.py``).

Reference semantics: seed at index 0, min-distance buffer initialised to
1e38, running minimum of SQUARED distances ``(dx*dx + dy*dy) + dz*dz``,
argmax with ties going to the lowest index.

A CUDA tensor goes to the kernel ``csrc/fps.cu``, a CPU tensor to
:func:`farthest_point_sample_plain`.
"""

from __future__ import annotations

import torch

from sph3d_gcn_torch import _build

FPS_KERNEL = _build.register(
    "fps", "sph3d_fps_launch",
    [_build.PTR, _build.PTR, _build.INT, _build.INT, _build.INT,
     _build.PTR],
)


def farthest_point_sample(
    npoint: int, database: torch.Tensor, use_kernels: bool | None = None
) -> torch.Tensor:
    """(B, N, 3+) coordinates -> (B, npoint) int64 indices."""
    n = database.shape[-2]
    if not 1 <= npoint <= n:
        raise ValueError(f"npoint must be in [1, num_points={n}], got {npoint}")
    _build.record("fps", npoint, database)
    if _build.use_kernel(database, use_kernels):
        return farthest_point_sample_kernel(npoint, database)
    return farthest_point_sample_plain(npoint, database)


def farthest_point_sample_plain(
    npoint: int, database: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch FPS: one vectorised step per selected point."""
    xyz = database[..., :3].float()
    batch, num, _ = xyz.shape
    rows = torch.arange(batch, device=xyz.device)
    min_d = torch.full((batch, num), 1e38, dtype=torch.float32,
                       device=xyz.device)
    out = torch.zeros((batch, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros(batch, dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        delta = xyz - xyz[rows, last][:, None, :]
        dx, dy, dz = delta.unbind(-1)
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=1)      # first maximal index
        out[:, j] = last
    return out


def farthest_point_sample_kernel(
    npoint: int, database: torch.Tensor
) -> torch.Tensor:
    """FPS through the CUDA kernel (one block per cloud, coordinates and
    min-distances in shared memory)."""
    xyz = database[..., :3].float().contiguous()
    _build.check(xyz, "xyz", torch.float32, 3)
    batch, num, _ = xyz.shape
    if 16 * num > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"the FPS kernel keeps a cloud in shared memory: N={num} points "
            f"exceed {_build.MAX_DYNAMIC_SMEM // 16}"
        )
    out = torch.empty((batch, npoint), dtype=torch.int32, device=xyz.device)
    FPS_KERNEL.launch(
        _build.ptr(xyz), _build.ptr(out), batch, num, npoint,
        _build.stream(xyz),
    )
    return out.to(torch.int64)
