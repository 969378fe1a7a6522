"""Per-epoch checkpoints with auto-resume, and the config snapshot
(counterpart of ``sph3d_gcn_tpu/train/checkpoint.py``, whose orbax format
needs JAX: the port keeps its own format).

Mirrors the reference's ``tf.train.Saver(max_to_keep=500)`` per-epoch
checkpoints with auto-resume from the latest one
(ref train_modelnet.py:188,214-224,236-239,254). A checkpoint is one
``torch.save`` file, ``<log_dir>/ckpt/<epoch>.pt``, holding the model's
``state_dict`` (parameters and BN statistics), the optimizer's and the
scheduler's state and the epoch; it is written under a temporary name
and renamed into place, so an interrupted save never becomes the latest.
Files are read with ``weights_only=True``. Under a data-parallel group
(every rank holds the same state) rank 0 writes and the others wait for
it at a barrier; every rank reads the same files. JAX's processes all
write identical files, which in one shared directory would race here.

The config snapshot keeps the JAX package's JSON format: a
``config.json`` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import torch

from sph3d_gcn_torch.configs.base import SPH3DConfig
from sph3d_gcn_torch.parallel.mesh import DataGroup, is_primary, spread

_NAME = re.compile(r"^(\d+)\.pt$")

# fields of the JAX config that the port's models do not read, with JAX's
# defaults: a JAX snapshot loads when each holds its default
_JAX_ONLY_DEFAULTS = {"mlp2": None, "num_parts": None}


class Checkpointer:
    """Per-epoch save and restore of a model, its optimizer and its
    scheduler under ``log_dir/ckpt``, keeping the newest
    ``max_to_keep``; with ``group`` (``parallel.DataGroup``) rank 0
    writes."""

    def __init__(self, log_dir: str | os.PathLike, max_to_keep: int = 500,
                 group: DataGroup | None = None):
        self._dir = os.path.join(os.path.abspath(log_dir), "ckpt")
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.group = group

    def _path(self, epoch: int) -> str:
        return os.path.join(self._dir, f"{epoch}.pt")

    def epochs(self) -> list[int]:
        """The saved epochs, ascending (unfinished saves are not listed)."""
        found = (_NAME.match(name) for name in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self) -> int | None:
        """The latest saved epoch, or None."""
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer | None = None,
             scheduler: torch.optim.lr_scheduler.LRScheduler | None = None,
             **extra) -> None:
        """Blocking per-epoch save (ref train_modelnet.py:254). ``extra``:
        more entries (ints, floats, strings, tensors) that
        :meth:`restore` returns. Under a group every rank calls it and
        returns once rank 0's file is in place."""
        if not is_primary(self.group):
            self.group.barrier()
            return
        payload = {"epoch": epoch, "model": model.state_dict(),
                   "extra": extra}
        if optimizer is not None:
            payload["optimizer"] = optimizer.state_dict()
        if scheduler is not None:
            payload["scheduler"] = scheduler.state_dict()
        path = self._path(epoch)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.epochs()[: -self.max_to_keep]:
            os.remove(self._path(old))
        if spread(self.group):
            self.group.barrier()

    def _load(self, model: torch.nn.Module, epoch: int | None) -> dict:
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        # read on the host: the loads below copy each tensor to its
        # owner's device (Adam's step counts stay on the host, as a
        # fresh optimizer keeps them)
        payload = torch.load(self._path(epoch), map_location="cpu",
                             weights_only=True)
        model.load_state_dict(payload["model"])
        return payload

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer | None = None,
                scheduler: torch.optim.lr_scheduler.LRScheduler | None = None,
                epoch: int | None = None) -> dict:
        """Load epoch ``epoch`` (None: the latest) into the model, the
        optimizer and the scheduler given; returns the save's ``extra``
        entries."""
        payload = self._load(model, epoch)
        for owner, key in ((optimizer, "optimizer"), (scheduler, "scheduler")):
            if owner is not None:
                if key not in payload:
                    raise KeyError(f"the checkpoint holds no {key} state")
                owner.load_state_dict(payload[key])
        return payload["extra"]

    def restore_variables(self, model: torch.nn.Module,
                          epoch: int | None = None) -> int:
        """Load only the model's parameters and BN statistics, for
        evaluation (the reference restores variables only,
        ref evaluate_modelnet.py:135); returns the epoch loaded."""
        return self._load(model, epoch)["epoch"]

    def close(self) -> None:
        """Nothing stays open between saves (JAX's API)."""


def snapshot_config(log_dir: str | os.PathLike, config: SPH3DConfig,
                    group: DataGroup | None = None) -> None:
    """Write the architecture config as JSON into the log dir (the
    reference's .py-copy trick, ref train_modelnet.py:53-55); under
    ``group``, rank 0 writes it."""
    if not is_primary(group):
        return
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)


def load_config_snapshot(log_dir: str | os.PathLike) -> SPH3DConfig:
    """Rebuild the config saved by ``snapshot_config`` of either package
    (the eval-time architecture reload, ref evaluate_modelnet.py:35-46).
    A field of the JAX config that the port lacks loads when it holds
    JAX's default; any other value raises ValueError naming it."""
    with open(os.path.join(log_dir, "config.json")) as f:
        payload = json.load(f)
    known = {f.name for f in dataclasses.fields(SPH3DConfig)}
    for key in [k for k in payload if k not in known]:
        value = payload.pop(key)
        if key not in _JAX_ONLY_DEFAULTS:
            raise ValueError(f"config.json field {key!r} is not a field of "
                             f"SPH3DConfig")
        if value != _JAX_ONLY_DEFAULTS[key]:
            raise ValueError(
                f"config.json sets {key}={value!r}: the PyTorch port runs "
                f"only {key}={_JAX_ONLY_DEFAULTS[key]!r}")
    # JSON turns tuples into lists; the frozen dataclass holds tuples
    for key, value in payload.items():
        if isinstance(value, list):
            payload[key] = tuple(
                tuple(v) if isinstance(v, list) else v for v in value
            )
    return SPH3DConfig(**payload)
