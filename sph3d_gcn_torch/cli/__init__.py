"""Command-line entry points (counterparts of the JAX package's
``scripts/``): ``python -m sph3d_gcn_torch.cli.<name>`` with ``name`` one
of ``train_modelnet``, ``evaluate_modelnet``, ``train_scene_seg`` and
``measure_windows``. Each runs on the CUDA card unless ``--device cpu``
asks for the plain versions on the CPU; asking for ``cuda`` where there
is none raises."""

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
