"""Command-line entry points (counterparts of the JAX package's
``scripts/``): ``python -m sph3d_gcn_torch.cli.<name>`` with ``name`` one
of

- ``train_modelnet`` and ``evaluate_modelnet`` (ModelNet40 votes);
- ``train_scene_seg`` (S3DIS, ScanNet, RueMonge2014),
  ``evaluate_scene_seg`` (coverage voting, the block-to-scene re-merge
  and its metrics) and ``aggregate_folds`` (the folds' counts summed);
- ``train_shapenet`` and ``evaluate_shapenet`` (per-category or one-hot
  part segmentation);
- ``measure_windows`` (the dense engine's windows for a dataset);
- ``parity_check`` (logits against the NumPy oracle or a TF1
  checkpoint's captured logits) and ``profile_step`` (a train step's
  device time by kernel and layer, each kernel against its bound);
- ``prepare_modelnet``, ``prepare_s3dis``, ``prepare_scannet``,
  ``prepare_shapenet`` and ``prepare_ruemonge2014`` (the datasets'
  published files into the records, scene files and lists the others
  read).

Each that runs a model runs on the CUDA card unless ``--device cpu``
asks for the plain versions on the CPU; asking for ``cuda`` where there
is none raises. So does ``prepare_modelnet``, whose farthest-point
sampling runs on the card. ``aggregate_folds`` and the other
``prepare_*`` read and write files only.

The three train and three evaluate entry points run data-parallel as R
ranks of one process group (:func:`add_parallel_args`), launched by
``torchrun``, which rendezvouses on the host and needs no network::

    torchrun --nproc_per_node 4 -m sph3d_gcn_torch.cli.train_modelnet \\
        --data_dir DIR --num_devices 4 --batch_size 32

Each rank drives ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo).
Ranks that share a card meet over gloo: those that outnumber the host's
cards, or name one card (``--device cuda:0``) for all of them
(:func:`rank_device`). Every rank reads every record and steps on its
rows of each global batch. Rank 0 writes every output file.

``--point_devices P`` shards each cloud's rows over P ranks
(``parallel.spatial``, the dense engine's ``--mode dense`` only), and
with ``--num_devices D`` the run is D replicas of P point ranks: launch
D x P ranks, rank r holding data index r // P and point index r % P::

    torchrun --nproc_per_node 2 -m sph3d_gcn_torch.cli.train_scene_seg \
        --dataset s3dis --data_dir DIR --mode dense --point_devices 2"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    PointGroup,
    current_group,
    init_data_parallel,
    is_primary,
    split_groups,
    spread,
)


def resolve_device(name: str) -> torch.device:
    """The ``--device`` flag as a device: ``cuda`` (the default) needs a
    card; nothing falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass "
            "--device cpu to run the plain versions on the CPU)")
    return device


def read_list(path: str) -> list[str]:
    """The file names listed one a line in ``path``."""
    with open(path) as f:
        return [line.rstrip() for line in f if line.strip()]


def rank_print(group: DataGroup | None):
    """``print`` on rank 0 (and without a group), silence elsewhere: the
    evaluate entry points' reports, which every rank computes alike."""
    if is_primary(group):
        return print
    return lambda *args, **kwargs: None


def add_parallel_args(parser: argparse.ArgumentParser) -> None:
    """The data-parallel flags (JAX's names where they mean the same)."""
    parser.add_argument(
        "--num_devices", type=int, default=None,
        help="data-parallel ranks, one device each: checked against the "
             "process group's size (launch them with torchrun "
             "--nproc_per_node N); default: torchrun's group, or one "
             "process")
    parser.add_argument(
        "--point_devices", type=int, default=None,
        help="point-axis sharding: ranks that split each cloud's rows, "
             "with halo exchanges (dense mode; parallel/spatial.py); the "
             "run then holds num_devices x point_devices ranks")
    parser.add_argument(
        "--multihost", action="store_true",
        help="accepted for the JAX scripts' flag: a group whose ranks "
             "span hosts (torchrun --nnodes > 1) needs no flag")


def rank_device(name: str, local_rank: int, local_ranks: int, cards: int
                ) -> tuple[torch.device, str]:
    """A rank's device and its group's backend from ``--device``, its
    rank and the number of ranks on its host, and the host's cards:

    - ``cpu``: the CPU, gloo;
    - ``cuda``: ``cuda:LOCAL_RANK`` over NCCL, one card a rank; ranks
      that outnumber the cards share them (``cuda:LOCAL_RANK % cards``)
      over gloo, since NCCL refuses two ranks on one device;
    - ``cuda:k``: that card for every rank of the host (``torchrun``
      gives each the same flags), so gloo when the host runs more than
      one rank.
    """
    device = torch.device(name)
    if device.type != "cuda":
        return device, "gloo"
    if device.index is None:
        device = torch.device("cuda", local_rank % max(cards, 1))
        shared = local_ranks > cards
    else:
        shared = local_ranks > 1
    return device, "gloo" if shared else "nccl"


def setup_parallel(args: argparse.Namespace
                   ) -> tuple[torch.device, DataGroup | None]:
    """This process's device and data-parallel group from the flags of
    :func:`add_parallel_args` and ``--device``: the group this process has
    already joined, else the one ``torchrun``'s environment describes
    (joined here, its device and backend from :func:`rank_device`), else
    one process (None). With ``--point_devices`` the group holds every
    rank of the run (:func:`setup_mesh` splits it)."""
    points = getattr(args, "point_devices", None) or 1
    joined = current_group("cpu")
    if joined is not None:
        size = joined.size
    elif "WORLD_SIZE" in os.environ:
        size = int(os.environ["WORLD_SIZE"])
    else:
        if args.num_devices not in (None, 1) or args.multihost \
                or points != 1:
            raise ValueError(
                f"--num_devices {args.num_devices} / --point_devices "
                f"{points} / --multihost: launch the ranks under torchrun "
                "--nproc_per_node N")
        return resolve_device(args.device), None
    if args.num_devices is not None and args.num_devices * points != size:
        raise ValueError(f"--num_devices {args.num_devices} x "
                         f"--point_devices {points}, but the process group "
                         f"has {size} ranks")
    if size % points:
        raise ValueError(f"--point_devices {points} does not divide the "
                         f"process group's {size} ranks")
    resolve_device(args.device)
    device, backend = rank_device(
        args.device, int(os.environ.get("LOCAL_RANK", 0)),
        int(os.environ.get("LOCAL_WORLD_SIZE", size)),
        torch.cuda.device_count())
    if joined is not None:
        return device, current_group(device)
    return device, init_data_parallel(device, backend)


def setup_mesh(args: argparse.Namespace
               ) -> tuple[torch.device, DataGroup | None, PointGroup | None]:
    """This process's device, data-parallel group and point group from
    the flags (:func:`setup_parallel`, then ``parallel.split_groups`` by
    ``--point_devices``; JAX's ``points_mesh``): no point group without
    the flag or at 1. Prints the layout on rank 0."""
    device, group = setup_parallel(args)
    points = getattr(args, "point_devices", None) or 1
    if group is None or points == 1:
        return device, group, None
    data, pts = split_groups(group, points)
    if is_primary(group):
        print(f"composed: {data.size} data x {pts.size} points ranks"
              if spread(data) else f"point-axis group: {pts.size} ranks",
              flush=True)
    return device, data, pts


def shard_config(cfg, group: DataGroup | None, points: PointGroup | None):
    """``cfg`` with the point sharding of a run's groups: ``point_axis``
    'points' (and ``data_axis`` 'data' across replicas) under a point
    group (which needs the dense engine), else ``cfg``."""
    if points is None:
        return cfg
    if not cfg.dense_graph:
        raise ValueError("--point_devices shards the dense engine: run "
                         "with --mode dense")
    return dataclasses.replace(
        cfg, point_axis="points",
        data_axis="data" if spread(group) else None)
