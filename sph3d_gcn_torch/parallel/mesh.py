"""Data parallelism over ``torch.distributed`` and the groups of point
sharding (counterpart of ``sph3d_gcn_tpu/parallel/mesh.py`` and of the
mesh that ``sph3d_gcn_tpu/train/cli.py``'s ``points_mesh`` builds).

JAX expresses data parallelism as a ('data', 'model') mesh: state
replicated, the batch sharded over 'data', and XLA computes the
unsharded step on the global batch. Its 'model' axis always has size 1
and, on a multi-slice mesh, 'dcn' x 'data' shard the batch jointly, so
pure data parallelism is one flat group of R ranks. Here each rank is one
process driving one device, and a :class:`DataGroup` names its place in
the group. Under :func:`data_parallel` (which ``train.steps.StepFactory``
enters around its forward; the backward's collectives carry their group
with them) the layers give the step its global-batch semantics:

- ``nn.layers.BatchNorm`` averages its batch statistics over the group
  (:func:`pmean`, whose backward averages the cotangent, as JAX's
  ``_pmean_sync``): every rank holds the same local batch size, so the
  mean of the ranks' means is the global mean;
- dropout and the sampling noise draw the world-1 step's global tensor
  from the shared generator and keep this rank's rows
  (:func:`draw_rows`), so the world size changes no value;
- the step all-reduces the gradients, losses and certificate failures
  once (``train.steps``).

Point sharding (``parallel.spatial``) splits the ranks further: with
P point ranks a replica, rank r holds data index r // P and point index
r % P (JAX's ``devices.reshape(num_devices, point_devices)``), and
:func:`split_groups` forms both kinds of group with ``dist.new_group``:
the P ranks of one replica (a :class:`PointGroup`, whose ranks hold one
batch and split each cloud's rows) and the ranks of one point index
across the replicas (a :class:`DataGroup`, over which the batch splits).
Under :func:`data_parallel` with a point group the sharded layers halo-
exchange their rows and average their batch statistics over both.

Nothing falls back: a group that does not form raises and NCCL is never
replaced by gloo. A group of one rank runs no collective in a step
(:func:`spread`): each would be the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import threading
from collections.abc import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

_ACTIVE = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class DataGroup:
    """One rank's view of the data-parallel group: the ranks over which
    the batch splits, which this process has joined.

    Attributes:
      rank, size: this process's rank in the group and the group's size R.
      device: where this rank's model lives and its collectives' tensors
        go (NCCL: its CUDA device; gloo: the CPU, or a CUDA device that
        several ranks may share).
      group: the ``torch.distributed`` process group its collectives run
        on; None: the default group (every rank of the run).
    """

    rank: int
    size: int
    device: torch.device
    group: object = None

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the group in place; returns it."""
        dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` (each of the same shape) concatenated
        along dim 0 in rank order: the global batch's rows."""
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(parts, tensor.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def local_rows(self, x):
        """This rank's rows of a global (gathered) tensor or array: rows
        ``[rank * b, (rank + 1) * b)`` with ``b = len(x) / R`` (JAX's
        ``_local_rows``). Raises when the rows do not split evenly."""
        if len(x) % self.size:
            raise ValueError(f"batch of {len(x)} does not split over "
                             f"{self.size} ranks")
        b = len(x) // self.size
        return x[self.rank * b:(self.rank + 1) * b]

    def sum_floats(self, *values: float) -> list[float]:
        """The group's sums of host numbers (f64: integer counts stay
        exact)."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        return self.all_reduce_(t).tolist()

    def barrier(self) -> None:
        """Wait until every rank of the group arrives (an all-reduce of
        one number on the group's device, which both backends run)."""
        self.sum_floats(0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class PointGroup(DataGroup):
    """One rank's view of its point group: the P ranks of one replica,
    which hold the same batch and split each cloud's rows into P
    contiguous chunks (``parallel.spatial``).

    Attributes (beside :class:`DataGroup`'s, ``rank`` being the point
    index):
      ranks: the global ranks of the group in point order (the peers of
        its point-to-point exchanges).
      backend: the group's backend: 'nccl' exchanges CUDA tensors with
        ``dist.batch_isend_irecv``; 'gloo' stages them through the host,
        since its send and receive take CPU tensors only.
    """

    ranks: tuple[int, ...] = ()
    backend: str = "gloo"


def split_groups(world: DataGroup, point_devices: int
                 ) -> tuple[DataGroup, PointGroup | None]:
    """This rank's data group and point group in a run of
    ``num_devices x point_devices`` ranks (``world``: the group of every
    rank, :func:`init_data_parallel`'s). Rank r holds data index r // P
    and point index r % P; every rank forms every group, as
    ``dist.new_group`` requires. ``point_devices`` 1 returns ``world``
    and no point group. Raises when the ranks do not split."""
    p = int(point_devices)
    if p < 1 or world.size % p:
        raise ValueError(f"{world.size} ranks do not split into point "
                         f"groups of {point_devices}")
    if p == 1:
        return world, None
    backend = dist.get_backend()
    replicas = world.size // p
    point_groups = [dist.new_group(list(range(d * p, (d + 1) * p)))
                    for d in range(replicas)]
    data_groups = [dist.new_group(list(range(i, world.size, p)))
                   for i in range(p)]
    d, i = divmod(world.rank, p)
    data = DataGroup(rank=d, size=replicas, device=world.device,
                     group=data_groups[i])
    points = PointGroup(rank=i, size=p, device=world.device,
                        group=point_groups[d],
                        ranks=tuple(range(d * p, (d + 1) * p)),
                        backend=backend)
    return data, points


def world_group(group: DataGroup | None, points: PointGroup | None
                ) -> DataGroup | None:
    """The group of every rank of a run whose data group is ``group`` and
    point group ``points``: ``group`` itself without point ranks (the
    checkpoints' barrier runs on it)."""
    if points is None:
        return group
    return DataGroup(rank=dist.get_rank(), size=dist.get_world_size(),
                     device=points.device)


def init_data_parallel(device: torch.device | str,
                       backend: str | None = None, *,
                       rank: int | None = None,
                       world_size: int | None = None,
                       store: dist.Store | None = None,
                       timeout: datetime.timedelta | None = None
                       ) -> DataGroup:
    """Join the process group and return this rank's :class:`DataGroup`.

    Args:
      device: this rank's device (``cuda:LOCAL_RANK`` under ``torchrun``
        with one card a rank; ranks that share a card name the same one).
      backend: 'nccl' (CUDA devices only) or 'gloo' (the CPU, or CUDA
        tensors staged through the host); None picks NCCL for a CUDA
        device and gloo for the CPU.
      rank, world_size, store: given together (tests, spawned ranks:
        ``torch.distributed.FileStore``); None reads ``torchrun``'s
        environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
      timeout: of the group's collectives (None: torch's default).

    Raises whatever ``init_process_group`` raises: nothing falls back.
    """
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device}: no CUDA device is available")
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": timeout}
    explicit = (rank, world_size, store)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("rank, world_size and store go together")
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kwargs)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group to join: {', '.join(missing)} not set "
                "(launch under torchrun --nproc_per_node N)")
        dist.init_process_group(backend, init_method="env://", **kwargs)
    return current_group(device)


def current_group(device: torch.device | str) -> DataGroup | None:
    """The :class:`DataGroup` of the process group this process has
    already joined (every rank's ``device``), or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DataGroup(rank=dist.get_rank(), size=dist.get_world_size(),
                     device=torch.device(device))


def spread(group: DataGroup | None) -> bool:
    """Whether ``group`` has other ranks to meet: a step under a group of
    one rank is the one-process step and runs no collective."""
    return group is not None and group.size > 1


def is_primary(group: DataGroup | None) -> bool:
    """Whether this process writes the run's files and reports: rank 0
    of the run (the point ranks of the first replica hold data rank 0
    alike), or the one process of a run without a group."""
    return group is None or (group.rank == 0 and _world()[0] == 0)


def close_data_parallel() -> None:
    """Leave the default process group (every rank calls it)."""
    dist.destroy_process_group()


@contextlib.contextmanager
def data_parallel(group: DataGroup | None,
                  points: PointGroup | None = None):
    """Run the enclosed forward (on this thread) with ``group``'s
    global-batch semantics (module docstring), its clouds' rows split
    over ``points`` where the config shards them; None runs it as one
    process does."""
    prev = (getattr(_ACTIVE, "group", None),
            getattr(_ACTIVE, "points", None))
    _ACTIVE.group, _ACTIVE.points = group, points
    try:
        yield
    finally:
        _ACTIVE.group, _ACTIVE.points = prev


def active_group() -> DataGroup | None:
    """The group of the enclosing :func:`data_parallel`, or None."""
    return getattr(_ACTIVE, "group", None)


def active_points() -> PointGroup | None:
    """The point group of the enclosing :func:`data_parallel`, or None."""
    return getattr(_ACTIVE, "points", None)


class _PMean(torch.autograd.Function):
    """The group mean whose backward is the group mean of the cotangent
    (the transpose of an average that every rank then uses: JAX's
    ``_pmean_sync``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: DataGroup) -> torch.Tensor:
        ctx.group = group
        return group.all_reduce_(x.clone()).div_(group.size)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return ctx.group.all_reduce_(ct.clone()).div_(ctx.group.size), None


def pmean(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, differentiable."""
    return _PMean.apply(x, group)


def draw_rows(draw: Callable[[tuple[int, ...]], torch.Tensor],
              shape: tuple[int, ...] | torch.Size) -> torch.Tensor:
    """Random draws of ``shape`` (batch axis first) for this rank: under
    :func:`data_parallel`, ``draw`` makes the global batch's tensor, R
    times the rows, and this rank keeps its rows; so every rank draws
    what a one-process step on the global batch draws from the same
    generator. Outside it, ``draw(shape)``."""
    group = active_group()
    shape = tuple(shape)
    if not spread(group):
        return draw(shape)
    return group.local_rows(draw((shape[0] * group.size,) + shape[1:]))


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard_files(files: Iterable[str],
                        process_index: int | None = None,
                        process_count: int | None = None) -> list[str]:
    """Split a file list over the ranks: rank i takes ``files[i::R]``, in
    order (JAX's, with the ranks of the default process group; one
    process: the list unchanged). The port's entry points do not shard
    their files: JAX's one process a host reads all of them, and so does
    each of the port's ranks (``train.loop.fit``)."""
    rank, size = _world()
    p = rank if process_index is None else process_index
    n = size if process_count is None else process_count
    if n <= 1:
        return list(files)
    return list(files)[p::n]


def local_batch_size(global_batch_size: int,
                     process_count: int | None = None) -> int:
    """Each rank's share of the global batch (JAX's)."""
    n = _world()[1] if process_count is None else process_count
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} does not split over "
            f"{n} processes")
    return global_batch_size // n


def shard_batch(batch: dict[str, np.ndarray], group: DataGroup | None
                ) -> dict[str, np.ndarray]:
    """This rank's rows of a global host batch (the port's
    ``shard_batch``: every rank holds the global batch, as JAX's
    single-host mesh does, and its step takes its rows). The global
    batch must split evenly; None returns it whole."""
    if group is None:
        return batch
    return {k: group.local_rows(v) for k, v in batch.items()}

