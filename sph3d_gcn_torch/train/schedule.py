"""Learning-rate schedule and optimizers of the reference training
scripts (counterpart of ``sph3d_gcn_tpu/train/schedule.py``).

ref modelnet40_cls/train_modelnet.py:74-82 (exponential decay with
staircase on *samples seen*, clipped at 1e-6) and :179-182 (Adam eps 1e-8
or Nesterov momentum). ``torch.optim.Adam`` has optax's update form, eps
outside the square root; the reference's L2 weight decay goes through the
loss (``nn.layers.l2_regularization``), never through the optimizer's
``weight_decay``.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

MIN_LEARNING_RATE = 1e-6  # ref train_modelnet.py:81

Schedule = Callable[[int], float]


def exponential_decay_lr(
    base_lr: float = 0.001,
    batch_size: int = 32,
    decay_step: int = 250000,
    decay_rate: float = 0.7,
) -> Schedule:
    """Staircase exponential decay on samples seen, floored at 1e-6: the
    learning rate of step ``count`` (0 for the first update). The
    reference decays on ``global_step * BATCH_SIZE`` against DECAY_STEP
    samples; per step that is a transition every
    ``decay_step // batch_size`` steps."""
    transition = max(1, decay_step // batch_size)

    def schedule(count: int) -> float:
        lr = base_lr * decay_rate ** math.floor(count / transition)
        return max(lr, MIN_LEARNING_RATE)

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    optimizer: str = "adam",
    learning_rate: float | Schedule = 0.001,
    momentum: float = 0.9,
    adam_epsilon: float = 1e-8,
) -> tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler]:
    """'adam' (eps configurable) or Nesterov 'momentum'
    (ref train_modelnet.py:179-182), with a scheduler that sets the
    learning rate of each step from ``learning_rate`` (a constant or a
    :data:`Schedule`). Call ``scheduler.step()`` after every
    ``optimizer.step()``; the first update uses ``learning_rate(0)``, as
    optax's count does."""
    sched = learning_rate if callable(learning_rate) else (
        lambda _count: float(learning_rate))
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=sched(0), eps=adam_epsilon)
    elif optimizer == "momentum":
        opt = torch.optim.SGD(params, lr=sched(0), momentum=momentum,
                              nesterov=True)
    else:
        raise ValueError(f"Unknown optimizer {optimizer!r}")
    return opt, _ScheduleLR(opt, sched)


class _ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's learning rate to ``schedule(step count)`` itself
    (``LambdaLR`` would multiply a factor into the base rate and round)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Schedule) -> None:
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self) -> list[float]:
        lr = self.schedule(self.last_epoch)
        return [lr for _ in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        """The step count and rates, without the schedule function (a
        closure: the owner rebuilds it from its arguments)."""
        return {k: v for k, v in super().state_dict().items()
                if k != "schedule"}
