"""Epoch-driven training loop with logging and checkpoint/resume
(counterpart of ``sph3d_gcn_tpu/train/loop.py``).

Replaces the reference's per-dataset `train_*.py` `sess.run` loops
(e.g. ref modelnet40_cls/train_modelnet.py:241-311): per-epoch train and
eval passes, per-``log_every``-batch loss and accuracy lines, the
wall-clock ms a batch, per-epoch checkpoints with auto-resume.

A dense-engine step whose certificate ``dense_ok`` comes back False has
updated the model from a possibly wrong graph. With
``on_dense_violation="fallback"`` (the default) ``fit`` restores the
pre-step model, optimizer and scheduler from a device copy taken before
each step (:class:`PreStepCopy`) and re-runs the batch through
``factory.classic_fallback()``, the per-edge engine on the same
parameters, built once; an eval batch that fails is re-run through the
fallback's eval step. Under point sharding (``factory.points``) a batch
whose only breach was a halo (``halo_ok`` False) first re-runs sharded
through ``factory.halo_widened()`` (twice the inter-level halos, built
once), and through the classic fallback only if that fails too, as
JAX's ``fit()`` does; each re-run is counted and logged.

Each train batch runs in a ``torch.profiler`` span ``fit_step`` (its
copy to the device, the step, its host reads of the loss, the
certificate and the logits), the pre-step copy in a span
``pre_step_copy``: a trace of ``fit`` reads each step's device time and
idle share from them.

Under a data-parallel group (``factory.group``) every rank's
``train_batches`` and ``eval_batches`` yield the same global batches
(every rank reads every record with the same seeds, as JAX's one
process a host does): each rank pads a batch to ``batch_size`` and
steps on its rows of it, so R ranks run what one process runs on the
same batches, batch for batch. The ranks restore and re-run together,
and rank 0 alone logs and writes the checkpoints. The logged losses are
the global batch's; the logged accuracies count every rank's rows (JAX
logs process 0's rows only). The point ranks of a replica step on the
same rows together.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Callable, Iterator
from datetime import datetime

import numpy as np
import torch
from torch.profiler import record_function

from sph3d_gcn_torch.data.datasets import pad_batch
from sph3d_gcn_torch.parallel.mesh import (
    is_primary,
    shard_batch,
    spread,
    world_group,
)
from sph3d_gcn_torch.train.checkpoint import Checkpointer
from sph3d_gcn_torch.train.steps import StepFactory

# generator streams of step_generator
TRAIN_STREAM, PRIME_STREAM = 0, 1


class Logger:
    """Tee to stdout and a log file (ref train_modelnet.py:56,68-71), plus
    a metrics.jsonl scalar stream (the TF-summary equivalent,
    ref train_modelnet.py:167-178,207-209). A logger that is not
    ``primary`` (a rank other than 0) opens nothing and stays silent, as
    JAX's on processes other than 0."""

    def __init__(self, log_dir: str, name: str = "log_train.txt",
                 primary: bool = True):
        self._primary = primary
        if not primary:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, name), "a")
        self._metrics = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, msg: str) -> None:
        if not self._primary:
            return
        self._f.write(msg + "\n")
        self._f.flush()
        print(msg, flush=True)

    def scalars(self, **kwargs) -> None:
        """Append one JSON line of scalar metrics."""
        if not self._primary:
            return
        self._metrics.write(json.dumps(kwargs) + "\n")
        self._metrics.flush()

    def close(self) -> None:
        if not self._primary:
            return
        self._f.close()
        self._metrics.close()


def step_generator(seed: int, step: int, device: torch.device | str,
                   stream: int = TRAIN_STREAM) -> torch.Generator:
    """The generator of train step ``step`` (dropout masks, IDS or random
    sampling noise), on ``device``: seeded from (seed, stream, step) alone,
    as JAX folds its key by the step count, so a resumed run draws what an
    uninterrupted one does."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def to_device(batch: dict[str, np.ndarray], device: torch.device
              ) -> dict[str, torch.Tensor]:
    """A host numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class PreStepCopy:
    """The state a train step changes, copied on the device before it:
    the model's parameters and buffers (BN statistics), the optimizer's
    tensors, and the optimizer's rates and the scheduler's counters on the
    host. The copies are allocated once (again only when the optimizer's
    state changes shape, at its first step) and filled with one
    ``torch._foreach_copy_`` per device and dtype."""

    def __init__(self, factory: StepFactory) -> None:
        self.model = factory.model
        self.optimizer = factory.optimizer
        self.scheduler = factory.scheduler
        self._keys: list | None = None
        self._copies: list[torch.Tensor] = []
        self._groups: list[list[int]] = []

    def _live(self) -> tuple[list[torch.Tensor], list]:
        tensors = list(self.model.parameters()) + list(self.model.buffers())
        keys = []
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                for k, v in self.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        tensors.append(v)
                        keys.append((id(p), k))
        return tensors, keys

    def save(self) -> None:
        tensors, keys = self._live()
        if keys != self._keys:
            self._keys = keys
            self._copies = [torch.empty_like(t) for t in tensors]
            kinds: dict = {}
            for i, t in enumerate(tensors):
                kinds.setdefault((t.device, t.dtype), []).append(i)
            self._groups = list(kinds.values())
        self._copy(self._copies, tensors)
        self._lrs = [g["lr"] for g in self.optimizer.param_groups]
        self._sched = self.scheduler.state_dict()

    def restore(self) -> None:
        tensors, keys = self._live()
        if keys != self._keys:
            # the step made the optimizer's state (its first): drop it
            saved = {pid for pid, _ in self._keys}
            for p in list(self.optimizer.state):
                if id(p) not in saved:
                    del self.optimizer.state[p]
            tensors, keys = self._live()
        self._copy(tensors, self._copies)
        for g, lr in zip(self.optimizer.param_groups, self._lrs):
            g["lr"] = lr
        self.scheduler.load_state_dict(self._sched)

    def _copy(self, dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
        with torch.no_grad():
            for idx in self._groups:
                torch._foreach_copy_([dst[i] for i in idx],
                                     [src[i] for i in idx])


def _batch_accuracy(logits: np.ndarray, batch: dict, bsize: int
                    ) -> tuple[int, int]:
    pred = logits[:bsize].argmax(-1)
    label = batch["label"][:bsize]
    if logits.ndim == 2:  # classification
        return int((pred == label).sum()), bsize
    if "inner_label" in batch:
        mask = batch["inner_label"][:bsize] > 0
        return int(((pred == label) & mask).sum()), int(mask.sum())
    return int((pred == label).sum()), pred.size


def fit(
    factory: StepFactory,
    train_batches: Callable[[int], Iterator[dict[str, np.ndarray]]],
    eval_batches: Callable[[], Iterator[dict[str, np.ndarray]]] | None,
    batch_size: int,
    num_epochs: int,
    log_dir: str,
    seed: int = 0,
    log_every: int = 50,
    on_dense_violation: str = "fallback",
    bn_prime_steps: int = 0,
) -> torch.nn.Module:
    """Train ``factory.model`` for ``num_epochs``, checkpointing each
    epoch and resuming from the latest checkpoint in ``log_dir``.

    Args:
      factory: a configured StepFactory; every batch goes to its model's
        device (the model and its state stay there).
      train_batches: epoch -> iterator of host numpy batches.
      eval_batches: optional () -> iterator for the per-epoch eval pass.
      batch_size: the fixed global batch size (a short batch is padded
        by repeating its last item; the eval loss counts real items only);
        under a group every rank is given the same global batches and
        steps on its ``batch_size / R`` rows of each.
      num_epochs: total epochs (resume-aware).
      log_dir: log and checkpoint directory.
      seed: seeds each step's generator with the step count
        (:func:`step_generator`).
      log_every: batches between loss and accuracy lines.
      on_dense_violation: for a dense-engine batch whose ``dense_ok`` is
        False: 'fallback' re-runs it from the pre-step state through
        ``factory.classic_fallback()``; 'raise' aborts; 'warn' logs and
        keeps the possibly wrong step. Per-edge configs are exact.
      bn_prime_steps: when > 0, each eval pass runs on BN statistics
        averaged over this many fresh training batches
        (``StepFactory.prime_step``); the training running statistics
        are put back after it. 0 keeps the reference's pure EMA.

    Returns:
      the trained model.
    """
    if on_dense_violation not in ("fallback", "raise", "warn"):
        raise ValueError(
            f"on_dense_violation must be 'fallback'|'raise'|'warn', "
            f"got {on_dense_violation!r}"
        )
    model = factory.model
    device = next(model.parameters()).device
    group = factory.group
    ranks = 1 if group is None else group.size
    if batch_size % ranks:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{ranks} processes")
    logger = Logger(log_dir, primary=is_primary(group))
    ckpt = Checkpointer(log_dir,
                        group=world_group(group, factory.points))

    def mine(batch: dict) -> tuple[dict, int]:
        """This rank's rows of a global batch padded to ``batch_size``,
        and how many of them are real items."""
        batch, bsize = pad_batch(batch, batch_size)
        if group is None:
            return batch, bsize
        local = batch_size // ranks
        return (shard_batch(batch, group),
                min(max(bsize - group.rank * local, 0), local))

    def group_sums(*values: float) -> list[float]:
        return group.sum_floats(*values) if spread(group) else list(values)

    dense_mode = bool(model.config.dense_graph)
    use_fallback = dense_mode and on_dense_violation == "fallback"
    pre_step = PreStepCopy(factory) if use_fallback else None
    fallback: dict[str, StepFactory] = {}
    reruns = {"halo": 0, "classic": 0}

    def _fallback(kind: str = "classic") -> StepFactory:
        if kind not in fallback:
            if kind == "halo":
                fallback[kind] = factory.halo_widened()
                logger.log("halo coverage violated: building the 2x-halo "
                           "sharded retry step")
            else:
                fallback[kind] = factory.classic_fallback()
                logger.log(
                    "dense window coverage violated: building the classic-"
                    "engine fallback step (exact per-edge ops)"
                )
        reruns[kind] += 1
        return fallback[kind]

    def _recover(metrics: dict, action: str | None, run) -> dict:
        """Re-run a batch by ``action`` ('halo': sharded at 2x halos,
        then classic if that fails too; 'classic'); ``run(factory)``
        runs the batch and returns its metrics."""
        if action == "halo":
            metrics = run(_fallback("halo"))
            if bool(metrics["dense_ok"]):
                return metrics
            logger.log("2x-halo retry still violated: falling back to the "
                       "classic engine")
            action = "classic"
        if action == "classic":
            metrics = run(_fallback())
        return metrics

    step = 0
    start_epoch = 0
    latest = ckpt.latest_epoch()
    if latest is not None:
        step = ckpt.restore(model, factory.optimizer, factory.scheduler,
                            latest)["step"]
        start_epoch = latest + 1
        logger.log(f"{datetime.now()} - resumed from epoch {latest}")

    violations = 0

    def _rerun(metrics: dict, where: str) -> str | None:
        """How a batch whose certificates read ``metrics`` re-runs: None
        (it stands), 'halo' (a halo-only breach under point sharding:
        sharded at 2x halos) or 'classic' (the per-edge engine); 'raise'
        raises here."""
        nonlocal violations
        if not dense_mode or bool(metrics["dense_ok"]):
            return None
        violations += 1
        if on_dense_violation == "raise":
            raise RuntimeError(
                f"dense window coverage violated during {where}; widen "
                "SPH3DConfig.windows (sph3d_gcn_torch.cli.measure_windows) "
                "or run with on_dense_violation='fallback'"
            )
        halo_only = (factory.points is not None
                     and not bool(metrics.get("halo_ok", True)))
        action = (("halo" if halo_only else "classic") if use_fallback
                  else None)
        logger.log(
            f"WARNING: dense window coverage violated during {where} "
            f"(violation #{violations}); "
            + {"halo": "re-running sharded with 2x halos",
               "classic": "re-running via the classic engine",
               None: "keeping the possibly-wrong step"}[action]
        )
        return action

    for epoch in range(start_epoch, num_epochs):
        logger.log(f"**** EPOCH {epoch:03d} ****")
        total_correct = total_seen = 0
        loss_sum = 0.0
        epoch_loss_sum = 0.0
        batch_idx = 0
        train_time = 0.0
        for batch in train_batches(epoch):
            batch, bsize = mine(batch)
            now = time.time()
            with record_function("fit_step"):
                dev_batch = to_device(batch, device)
                if pre_step is not None:
                    with record_function("pre_step_copy"):
                        pre_step.save()
                metrics = factory.train_step(
                    dev_batch, step_generator(seed, step, device))
                loss = float(metrics["loss"])  # host sync
                action = _rerun(metrics, f"epoch {epoch} batch {batch_idx}")
                if action is not None:
                    # redo the batch from the pre-step state; the failed
                    # step's update is discarded

                    def run(f, batch=dev_batch, step=step):
                        pre_step.restore()
                        return f.train_step(
                            batch, step_generator(seed, step, device))

                    metrics = _recover(metrics, action, run)
                    loss = float(metrics["loss"])
                step += 1
                train_time += time.time() - now
                logits = metrics["logits"].float().cpu().numpy()
            c, s = _batch_accuracy(logits, batch, bsize)
            total_correct += c
            total_seen += s
            loss_sum += loss
            epoch_loss_sum += loss
            batch_idx += 1
            if batch_idx % log_every == 0:
                total_correct, total_seen = group_sums(total_correct,
                                                       total_seen)
                logger.log(f" ---- batch: {batch_idx:03d} ----")
                logger.log(f"mean loss: {loss_sum / log_every:f}")
                logger.log(
                    f"accuracy: {total_correct / max(1, total_seen):f}"
                )
                total_correct = total_seen = 0
                loss_sum = 0.0
        if batch_idx:
            logger.log(
                "training one batch require %.2f milliseconds"
                % (1000 * train_time / batch_idx)
            )
            logger.scalars(
                epoch=epoch,
                step=step,
                train_loss=epoch_loss_sum / batch_idx,
                ms_per_batch=1000 * train_time / batch_idx,
            )

        if eval_batches is not None:
            running = None
            if bn_prime_steps > 0:
                running = _prime(factory, map(mine, train_batches(epoch)),
                                 bn_prime_steps, seed, device, logger)
            logger.log(f"---- EPOCH {epoch:03d} EVALUATION ----")
            ev_correct = ev_seen = 0
            ev_loss = 0.0
            ev_items = 0
            ev_batches = 0
            for batch in eval_batches():
                # the step gathers the whole batch's logits and item
                # losses: every rank counts the global batch
                batch, bsize = pad_batch(batch, batch_size)
                dev_batch = to_device(mine(batch)[0], device)
                metrics = factory.eval_step(dev_batch)
                action = _rerun(metrics, f"epoch {epoch} eval")
                metrics = _recover(
                    metrics, action,
                    lambda f, batch=dev_batch: f.eval_step(batch))
                if "item_loss" in metrics:
                    # real items only: padded repeats of the last item
                    # would bias short final batches
                    ev_loss += float(metrics["item_loss"][:bsize].sum())
                    ev_items += bsize
                else:
                    ev_loss += float(metrics["loss"])
                    ev_items += 1
                logits = metrics["logits"].float().cpu().numpy()
                c, s = _batch_accuracy(logits, batch, bsize)
                ev_correct += c
                ev_seen += s
                ev_batches += 1
            if running is not None:
                model.load_state_dict(running, strict=False)
            if ev_batches:
                logger.log(f"eval mean loss: {ev_loss / max(1, ev_items):f}")
                logger.log(
                    f"eval accuracy: {ev_correct / max(1, ev_seen):f}")
                logger.scalars(
                    epoch=epoch,
                    eval_loss=ev_loss / max(1, ev_items),
                    eval_accuracy=ev_correct / max(1, ev_seen),
                )

        ckpt.save(epoch, model, factory.optimizer, factory.scheduler,
                  step=step)
        logger.log(f"Model saved at epoch {epoch}")

    if violations:
        logger.log(
            f"dense window coverage violations total: {violations} "
            + ("(steps kept — results may be wrong)" if not use_fallback
               else "(all re-run through the classic engine)"
               if not reruns["halo"]
               else f"(re-runs: {reruns['halo']} sharded at 2x halos, "
               f"{reruns['classic']} through the classic engine)")
        )
    ckpt.close()
    logger.close()
    return model


def _prime(factory: StepFactory, batches, num: int, seed: int,
           device: torch.device, logger: Logger
           ) -> dict[str, torch.Tensor] | None:
    """Install BN statistics averaged over up to ``num`` of ``batches``
    (padded, (batch, real items); batch i's dropout drawn from the prime
    stream's generator i, as JAX's folds its key by i); returns the
    running statistics they replace (None: no batch)."""
    sums = None
    primed = 0
    for batch, _ in batches:
        if primed >= num:
            break
        stats = factory.prime_step(
            to_device(batch, device),
            step_generator(seed, primed, device, PRIME_STREAM))
        sums = stats if sums is None else {k: sums[k] + v
                                           for k, v in stats.items()}
        primed += 1
    if not primed:
        return None
    state = factory.model.state_dict()
    running = {k: state[k].clone() for k in sums}
    factory.model.load_state_dict({k: v / primed for k, v in sums.items()},
                                  strict=False)
    logger.log(f"primed BN stats over {primed} batches")
    return running
