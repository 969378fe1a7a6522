"""Point sampling (counterpart of ``sph3d_gcn_tpu/ops/sample.py`` and its
Pallas kernel ``ops/pallas/fps_kernel.py``).

Farthest-point sampling, reference semantics: seed at index 0,
min-distance buffer initialised to 1e38, running minimum of SQUARED
distances ``(dx*dx + dy*dy) + dz*dz``, argmax with ties going to the
lowest index. A CUDA tensor goes to the kernel ``csrc/fps.cu``, a CPU
tensor to :func:`farthest_point_sample_plain`.

Inverse-density and random sampling draw noise (plain PyTorch, as the
JAX package leaves them to XLA). Each takes an explicit
``torch.Generator`` or the draws themselves: torch cannot reproduce
JAX's PRNG, so tests hand both sides the same draws.
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


# the smallest normal f32: the lower end of IDS's uniform draws, as JAX's
# ``jax.random.uniform(minval=jnp.finfo(jnp.float32).tiny)``
_TINY = float(torch.finfo(torch.float32).tiny)


def inverse_density_sample(
    npoint: int,
    probability: torch.Tensor,
    generator: torch.Generator | None = None,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample ``npoint`` indices per cloud with probability ~
    ``probability`` by Gumbel-max (ref tf_sample.py:27-41): the top
    ``npoint`` of ``log(prob) + Gumbel(u)``, ``u`` uniform in
    ``[tiny, 1)``.

    Args:
      npoint: S.
      probability: (B, N) f32 non-negative weights (the mean neighbor
        distance, an inverse-density proxy, ref utils/sph3gcn_util.py:37-39).
      generator: draws ``u`` (on ``probability``'s device; None: PyTorch's
        default generator) unless ``uniform`` is given.
      uniform: (B, N) draws in ``[tiny, 1)`` to use instead.

    Returns:
      (B, S) int64 indices in descending order of the perturbed log
      probability. Ties (equal keys: ``log 0 = -inf`` rows) go to the lower
      index, as ``lax.top_k`` breaks them: a stable descending sort
      (``torch.topk`` on CUDA promises no order among ties).
    """
    num = probability.shape[1]
    if not 1 <= npoint <= num:
        raise ValueError(f"npoint must be in [1, num_points={num}], got "
                         f"{npoint}")
    if uniform is None:
        uniform = torch.rand(probability.shape, generator=generator,
                             device=probability.device).clamp_min(_TINY)
    elif uniform.shape != probability.shape:
        raise ValueError(f"uniform draws {tuple(uniform.shape)} for "
                         f"probabilities {tuple(probability.shape)}")
    u = uniform.to(device=probability.device, dtype=torch.float32)
    key = torch.log(probability.float()) - torch.log(-torch.log(u))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    return order[:, :npoint]


def random_sample(
    npoint: int,
    database: torch.Tensor,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
) -> torch.Tensor:
    """Uniform random sampling with replacement (ref tf_sample.py:44-49):
    (B, npoint) int64 indices in [0, N), drawn from ``generator`` (on
    ``database``'s device; None: PyTorch's default) unless ``indices``
    (the draws themselves) is given."""
    batch, num = database.shape[0], database.shape[1]
    if indices is None:
        return torch.randint(0, num, (batch, npoint), generator=generator,
                             device=database.device)
    if indices.shape != (batch, npoint):
        raise ValueError(f"indices {tuple(indices.shape)}, want "
                         f"{(batch, npoint)}")
    return indices.to(device=database.device, dtype=torch.int64)
