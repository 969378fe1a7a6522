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
``prepare_*`` read and write files only."""

from __future__ import annotations

import torch


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
