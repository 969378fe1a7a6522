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
rows of each global batch. Rank 0 writes every output file."""

from __future__ import annotations

import argparse
import os

import torch

from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    current_group,
    init_data_parallel,
    is_primary,
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
    one process (None)."""
    joined = current_group("cpu")
    if joined is not None:
        size = joined.size
    elif "WORLD_SIZE" in os.environ:
        size = int(os.environ["WORLD_SIZE"])
    else:
        if args.num_devices not in (None, 1) or args.multihost:
            raise ValueError(
                f"--num_devices {args.num_devices} / --multihost: launch "
                "the ranks under torchrun --nproc_per_node N")
        return resolve_device(args.device), None
    if args.num_devices is not None and args.num_devices != size:
        raise ValueError(f"--num_devices {args.num_devices}, but the "
                         f"process group has {size} ranks")
    resolve_device(args.device)
    device, backend = rank_device(
        args.device, int(os.environ.get("LOCAL_RANK", 0)),
        int(os.environ.get("LOCAL_WORLD_SIZE", size)),
        torch.cuda.device_count())
    if joined is not None:
        return device, current_group(device)
    return device, init_data_parallel(device, backend)
