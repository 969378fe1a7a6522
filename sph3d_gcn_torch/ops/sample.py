"""Point sampling (counterpart of ``sph3d_gcn_tpu/ops/sample.py`` and its
Pallas kernel ``ops/pallas/fps_kernel.py``).

Farthest-point sampling, reference semantics: seed at index 0,
min-distance buffer initialised to 1e38, running minimum of SQUARED
distances ``(dx*dx + dy*dy) + dz*dz``, argmax with ties going to the
lowest index. A CUDA tensor goes to the kernel ``csrc/fps.cu``, a CPU
tensor to :func:`farthest_point_sample_plain`. The kernel holds a cloud of
up to ``REGISTER_MAX_POINTS`` in registers, one block or a thread block
cluster of up to 8 CTAs a cloud, and walks a larger one in device memory
with a cluster, as :func:`fps_plan` chooses from the shapes.

Inverse-density and random sampling draw noise (plain PyTorch, as the
JAX package leaves them to XLA). Each takes an explicit
``torch.Generator`` or the draws themselves: torch cannot reproduce
JAX's PRNG, so tests hand both sides the same draws.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from sph3d_gcn_torch import _build

FPS_KERNEL = _build.register(
    "fps", "sph3d_fps_launch",
    [_build.PTR, _build.LONG, _build.LONG, _build.PTR, _build.PTR,
     _build.INT, _build.INT, _build.INT, _build.INT, _build.INT, _build.INT,
     _build.PTR],
)

# points a thread may hold in registers: the kernel instances that
# csrc/fps.cu builds (SPH3D_FPS_PPT); a plan of another count fails to
# launch
PPT_SIZES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16)
MAX_CLUSTER = 8          # CTAs a cloud spreads over: the portable size
MAX_CANDIDATES = 32      # warp winners a step reduces: one a lane
# the largest cloud held in registers: 8 CTAs of 4 warps, 16 points a
# thread (196 KB of shared memory a CTA for its copy of the cloud); a
# larger one stays in device memory (ppt = 0)
REGISTER_MAX_POINTS = MAX_CLUSTER * 4 * 32 * PPT_SIZES[-1]
BLOCK_MAX_POINTS = 3072  # a cloud this small takes one block
BLOCK_PPT = 6            # a block plan's points a thread, at most
STREAM_THREADS = 1024    # a CTA of the device-memory plan


def max_threads(ppt: int) -> int:
    """Threads a CTA may have at ``ppt`` points a thread: the kernel's
    launch bounds (64 registers a thread up to 6 points, 128 above), so a
    plan with more threads fails to launch."""
    return 1024 if ppt <= 6 else 512


@dataclasses.dataclass(frozen=True)
class FpsPlan:
    """How K1 lays out a cloud: ``cluster`` CTAs (1: one block),
    ``threads`` a CTA, ``ppt`` points a thread. Thread t of CTA r holds
    points ``r * threads * ppt + k * threads + t`` for k < ppt; with
    ``ppt`` 0 the cloud stays in device memory and thread t of CTA r walks
    points ``r * threads + t + k * cluster * threads``."""

    cluster: int
    threads: int
    ppt: int

    def __str__(self) -> str:
        held = f"P={self.ppt}" if self.ppt else "in memory"
        return f"C={self.cluster} T={self.threads} {held}"


def fit_plan(n: int, cluster: int, warps: int, ppt: int) -> FpsPlan | None:
    """The plan of at most ``cluster`` CTAs that covers ``n`` points with
    the fewest warps a CTA (a multiple of 4, at most ``warps``), then the
    fewest points a thread (at most ``ppt``), then the fewest CTAs (none
    without a point). Whole groups of 4 warps keep an SM's 4 schedulers
    evenly loaded."""
    for w in range(4, warps + 1, 4):
        for p in PPT_SIZES:
            if p > ppt or 32 * w > max_threads(p):
                break
            if cluster * 32 * w * p >= n:
                return FpsPlan(-(-n // (32 * w * p)), 32 * w, p)
    return None


def fps_plan(batch: int, n: int,
             max_active: Callable[[FpsPlan], int]) -> FpsPlan:
    """K1's launch plan for ``batch`` clouds of ``n`` points, from the
    shapes alone. A small cloud takes a block of as few warps as hold it
    at up to ``BLOCK_PPT`` points a thread, a larger one a cluster of
    4-warp CTAs holding it in registers, and one beyond
    ``REGISTER_MAX_POINTS`` a cluster of ``STREAM_THREADS``-thread CTAs
    walking it in device memory: the largest cluster size whose ``batch``
    clusters run in one wave (``max_active(plan)``: clusters the device
    runs at once), else the one with the fewest waves."""
    if n < 1:
        raise ValueError(f"the FPS kernel takes clouds of at least one "
                         f"point, got N={n}")
    if n <= BLOCK_MAX_POINTS:
        return fit_plan(n, 1, 32, BLOCK_PPT)
    best, best_waves = None, None
    for cluster in range(MAX_CLUSTER, 1, -1):
        if n > REGISTER_MAX_POINTS:
            plan = FpsPlan(cluster, STREAM_THREADS, 0)
        else:
            plan = fit_plan(n, cluster, MAX_CANDIDATES // cluster,
                            PPT_SIZES[-1])
        active = max_active(plan) if plan is not None else 0
        if active < 1:
            continue
        waves = -(-batch // active)
        if best is None or waves < best_waves:
            best, best_waves = plan, waves
    if best is None:
        raise RuntimeError("no cluster of the FPS kernel runs on this "
                           "device (an sm_90 build needs Hopper)")
    return best


_MAX_ACTIVE: dict[tuple, int] = {}


def max_active_clusters(plan: FpsPlan) -> int:
    """Clusters of ``plan`` that the current device runs at once, one CTA
    an SM (``cudaOccupancyMaxActiveClusters``), queried once a plan."""
    key = (torch.cuda.current_device(), plan)
    if key not in _MAX_ACTIVE:
        fn = _build.library().sph3d_fps_max_active_clusters
        fn.argtypes = [_build.INT] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        count = ctypes.c_int(0)
        err = fn(plan.cluster, plan.threads, plan.ppt, ctypes.byref(count))
        if err != 0:
            msg = _build.library().sph3d_error_string(err).decode()
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters for the FPS "
                               f"kernel ({plan}): CUDA error {err}: {msg}")
        _MAX_ACTIVE[key] = count.value
    return _MAX_ACTIVE[key]


_PLANS: dict[tuple, FpsPlan] = {}


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
    npoint: int, database: torch.Tensor, plan: FpsPlan | None = None
) -> torch.Tensor:
    """FPS through the CUDA kernel: (B, N, 3+) coordinates -> (B, npoint)
    int64 indices. A contiguous f32 ``database`` is read as it is (its
    first 3 channels), any other is converted first. ``plan``: the launch
    plan (:func:`fps_plan`'s for the shapes by default)."""
    if database.dtype != torch.float32 or not database.is_contiguous():
        database = database[..., :3].float().contiguous()
    _build.check(database, "database", torch.float32, 3)
    batch, num, chans = database.shape
    if chans < 3 or not 1 <= npoint <= num:
        raise ValueError(f"want (B, N, 3+) coordinates and 1 <= npoint <= "
                         f"N, got {tuple(database.shape)} and {npoint}")
    if plan is None:
        key = (database.device.index, batch, num)
        plan = _PLANS.get(key)
        if plan is None:
            plan = _PLANS[key] = fps_plan(batch, num, max_active_clusters)
    out = torch.empty((batch, npoint), dtype=torch.int64,
                      device=database.device)
    # the device-memory plan's x, y, z and running minimum of each point
    scratch = (torch.empty((batch, num, 4), dtype=torch.float32,
                           device=database.device) if plan.ppt == 0
               else None)
    FPS_KERNEL.launch(
        _build.ptr(database), num * chans, chans,
        None if scratch is None else _build.ptr(scratch), _build.ptr(out),
        batch, num, npoint, plan.cluster, plan.threads, plan.ppt,
        _build.stream(database),
    )
    return out


# the smallest normal f32: the lower end of IDS's uniform draws, as JAX's
# ``jax.random.uniform(minval=jnp.finfo(jnp.float32).tiny)``
_TINY = float(torch.finfo(torch.float32).tiny)


def ids_uniform(shape, generator: torch.Generator | None,
                device: torch.device) -> torch.Tensor:
    """The uniforms in ``[tiny, 1)`` that :func:`inverse_density_sample`
    draws from ``generator`` for probabilities of ``shape``."""
    return torch.rand(shape, generator=generator,
                      device=device).clamp_min(_TINY)


def random_indices(shape, num: int, generator: torch.Generator | None,
                   device: torch.device) -> torch.Tensor:
    """The indices in ``[0, num)`` that :func:`random_sample` draws from
    ``generator``, of ``shape`` (B, npoint)."""
    return torch.randint(0, num, shape, generator=generator, device=device)


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
        uniform = ids_uniform(probability.shape, generator,
                              probability.device)
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
        return random_indices((batch, npoint), num, generator,
                              database.device)
    if indices.shape != (batch, npoint):
        raise ValueError(f"indices {tuple(indices.shape)}, want "
                         f"{(batch, npoint)}")
    return indices.to(device=database.device, dtype=torch.int64)
