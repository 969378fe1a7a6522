"""Train and eval steps (counterpart of ``sph3d_gcn_tpu/train/steps.py``).

One train step: the train-mode forward (batch-statistics BN, which
updates the running statistics in place; dropout, and the noise of IDS
or random sampling, from one explicit generator), the data loss plus
``weight_decay * l2_regularization``, the backward through every layer
(the dense conv and pool through their hand-written backward kernels on
a CUDA device), one optimizer update and one scheduler step. The metrics
stay on the device: the step adds no host synchronisation of its own. A
dense step whose certificate ``dense_ok`` came back False has applied an
update from a possibly wrong graph; ``train.loop.fit`` restores the
pre-step state and re-runs the batch through
:meth:`StepFactory.classic_fallback`, as JAX's ``fit()`` does.

With a ``group`` (``parallel.DataGroup``) each of the R ranks runs the
step on its rows of the global batch and the step computes what one
process computes on the whole of it, as JAX's ``mesh=`` steps do: batch
norm and the random draws follow ``parallel.data_parallel``; each rank's
objective is its data loss over R (a ``"mean"`` loss) or as it is (the
``"sum"`` of the inner-masked scene loss) plus the replicated weight
decay over R, so one all-reduce sums the gradients into the global
batch's. That all-reduce also carries the loss, the data loss and the
certificate failures, so every rank returns the global loss and data
loss and one ``dense_ok`` (every rank's certificate held), and takes the
same fallback decision. Nothing syncs the parameters afterwards: every
rank applies the same update to the same state. A group of one rank
runs the one-process step, with no collective.

With ``points`` (a ``parallel.PointGroup``; the model's config names a
``point_axis``) the P ranks of a replica hold the same rows of the batch
and split each cloud's rows (``parallel.spatial``); the model gathers the
logits, so every point rank computes the same loss. Each rank's
objective is then its data loss over D x P (a ``"mean"`` loss, or
without a data group) or over P (the ``"sum"`` loss across D replicas),
plus the weight decay over D x P, summed in the forward by
``parallel.spatial.psum_replicated`` (identity backward) into the global
loss; one all-reduce over the point group and one over the data group
then sum the gradients into the global batch's (JAX's psum of the
gradients over both axes). The metrics carry ``halo_ok`` beside
``dense_ok``; :meth:`StepFactory.halo_widened` re-runs a halo-only
breach sharded at twice the inter-level halos, and
:meth:`StepFactory.classic_fallback` runs each replica's rows unsharded
on the per-edge engine.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from sph3d_gcn_torch.models.common import classic_clone, halo_clone
from sph3d_gcn_torch.nn.layers import BatchNorm, l2_regularization
from sph3d_gcn_torch.parallel.mesh import (
    DataGroup,
    PointGroup,
    data_parallel,
    spread,
)
from sph3d_gcn_torch.parallel.spatial import psum_replicated

# (logits, batch) -> data loss (scalar) or per-item loss (B,)
LossFn = Callable[[torch.Tensor, dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass
class StepFactory:
    """A model, its optimizer and scheduler, and the loss.

    Args:
      model: a module whose forward is ``(points, *extra, use_kernels=,
        generator=, sample_noise=)``; after each forward its ``dense_ok`` holds the
        window-coverage certificate (a bool tensor).
      optimizer, scheduler: from ``train.schedule.make_optimizer``.
      loss_fn: maps (logits, batch) to the data loss.
      weight_decay: the reference's L2 coefficient on
        ``l2_regularization(model)``, or None.
      item_loss_fn: optional (logits, batch) -> (B,) per-item loss, which
        eval steps return.
      use_kernels: forwarded to the model (None: kernels on a CUDA
        device, plain versions on the CPU; False: plain versions).
      model_kwargs_keys: batch keys passed to the model after the points,
        in this order (the ShapeNet one-hot model's ``cls_label``), by
        every step, the fallback's included.
      group: the data-parallel group, or None for one process: each
        batch is then this rank's rows of the global batch.
      loss_reduction: how ``loss_fn`` reduces over the batch's items,
        ``"mean"`` or ``"sum"`` (the inner-masked scene loss), so that the
        ranks' losses sum to the global one.
      points: the point group of a point-sharded model (whose config
        sets ``point_axis``), or None.
    """

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    loss_fn: LossFn
    weight_decay: float | None = None
    item_loss_fn: LossFn | None = None
    use_kernels: bool | None = None
    model_kwargs_keys: tuple[str, ...] = ()
    group: DataGroup | None = None
    loss_reduction: str = "mean"
    points: PointGroup | None = None

    def __post_init__(self) -> None:
        if self.loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction must be 'mean' or 'sum', got "
                             f"{self.loss_reduction!r}")
        axis = getattr(self.model.config, "point_axis", None)
        if (axis is None) != (self.points is None):
            raise ValueError(
                f"the model's point_axis is {axis!r} but the step has "
                f"{'no' if self.points is None else 'a'} point group: set "
                "both or neither")

    def _forward(self, batch, generator, sample_noise=None):
        extra = [batch[k] for k in self.model_kwargs_keys]
        with data_parallel(self.group, self.points):
            return self.model(batch["points"], *extra,
                              use_kernels=self.use_kernels,
                              generator=generator, sample_noise=sample_noise)

    def _losses(self, batch, generator, sample_noise=None):
        """(objective, data loss, logits): under a group, this rank's
        share of the global objective and data loss (module docstring)."""
        logits = self._forward(batch, generator, sample_noise)
        data_loss = self.loss_fn(logits, batch)
        decay = None
        if self.weight_decay is not None:
            decay = self.weight_decay * l2_regularization(self.model)
        if self.points is not None:
            # every point rank holds the replica's loss: the JAX step's
            # reassembly (module docstring)
            replicas = self.group.size if spread(self.group) else 1
            denom = replicas * self.points.size
            scale = (1.0 / denom if self.loss_reduction == "mean"
                     or replicas == 1 else 1.0 / self.points.size)
            part = data_loss * scale
            if decay is not None:
                part = part + decay / denom
            total = psum_replicated(part, self.points, self.group)
            if replicas > 1:
                # the global data loss (the weight decay is replicated)
                data_loss = total if decay is None else total - decay
            return total, data_loss, logits
        if spread(self.group):
            ranks = self.group.size
            if self.loss_reduction == "mean":
                data_loss = data_loss * (1.0 / ranks)
            if decay is not None:
                decay = decay / ranks
        total = data_loss if decay is None else data_loss + decay
        return total, data_loss, logits

    def _spread(self) -> bool:
        return spread(self.group) or spread(self.points)

    def _halo_ok(self) -> torch.Tensor:
        ok = getattr(self.model, "halo_ok", None)
        return (torch.ones((), dtype=torch.bool,
                           device=self.model.dense_ok.device)
                if ok is None else ok)

    def _agree(self, total, data_loss, grads=()):
        """Sum the ranks' objectives, data losses (unless the forward
        summed them: point sharding), certificate failures and ``grads``
        (in place) in one all-reduce a group; returns the global (loss,
        data loss, dense_ok, halo_ok) and leaves both certificates on the
        model."""
        failed = torch.stack([~self.model.dense_ok,
                              ~self._halo_ok()]).to(torch.float32)
        sums = [] if self.points is not None else [
            total.detach().reshape(1).float(),
            data_loss.detach().reshape(1).float()]
        flat = torch.cat([g.reshape(-1) for g in grads] + sums + [failed])
        for group in (self.points, self.group):
            if spread(group):
                group.all_reduce_(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        if sums:
            total, data_loss = flat[-4], flat[-3]
        ok, halo_ok = flat[-2] == 0, flat[-1] == 0
        self.model.dense_ok, self.model.halo_ok = ok, halo_ok
        return total, data_loss, ok, halo_ok

    def loss_and_grads(self, batch: dict[str, torch.Tensor],
                       generator: torch.Generator | None = None,
                       sample_noise: list[torch.Tensor] | None = None
                       ) -> dict[str, torch.Tensor]:
        """The train-mode forward and backward without the update: leaves
        the gradients in each parameter's ``.grad`` (and the running BN
        statistics updated) and returns the step's metrics. ``generator``
        draws the dropout masks and the sampling noise (IDS, random);
        ``sample_noise`` gives each level's sampling draws instead (the
        model's forward). The certificates stay on the device: no host
        read. Under a group the gradients, ``loss``, ``data_loss``,
        ``dense_ok`` and ``halo_ok`` are the global batch's (one
        all-reduce a group after the backward) and ``logits`` this
        replica's rows."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total, data_loss, logits = self._losses(batch, generator,
                                                sample_noise)
        total.backward()
        ok, halo_ok = self.model.dense_ok, self._halo_ok()
        if self._spread():
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            total, data_loss, ok, halo_ok = self._agree(total, data_loss,
                                                        grads)
        return {"loss": total.detach(), "data_loss": data_loss.detach(),
                "logits": logits.detach(), "dense_ok": ok,
                "halo_ok": halo_ok}

    def train_step(self, batch: dict[str, torch.Tensor],
                   generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        """One step on ``batch`` (``points``, and the labels the loss
        reads): returns ``loss``, ``data_loss``, ``logits``, ``dense_ok``
        and ``halo_ok``, all device tensors."""
        metrics = self.loss_and_grads(batch, generator)
        self.optimizer.step()
        self.scheduler.step()
        return metrics

    def prime_step(self, batch: dict[str, torch.Tensor],
                   generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        """Each BN layer's batch statistics of ``batch``: one train-mode
        forward without gradients, whose running-statistics update
        ``new = m * old + (1 - m) * batch`` gives the batch statistic back
        as ``(new - m * old) / (1 - m)`` (m = 0.99, JAX's
        ``prime_step``). Returns {state-dict key of each ``mean`` and
        ``var`` buffer: statistic}; the running statistics are left as
        they were. ``fit(bn_prime_steps=N)`` averages these over N
        batches for its eval pass: the momentum-0.99 running averages
        lag on short runs. Under a group: the global batch's
        statistics, on every rank."""
        stats = [(f"{name}.{k}", getattr(bn, k), bn.momentum)
                 for name, bn in self.model.named_modules()
                 if isinstance(bn, BatchNorm) for k in ("mean", "var")]
        old = [buf.clone() for _, buf, _ in stats]
        self.model.train()
        out = {}
        with torch.no_grad():
            self._forward(batch, generator)
            for (key, buf, m), prev in zip(stats, old):
                out[key] = (buf - m * prev) / (1.0 - m)
                buf.copy_(prev)
        return out

    def halo_widened(self, scale: int = 2) -> StepFactory:
        """A point-sharded StepFactory on the SAME parameters, buffers,
        optimizer and scheduler with the inter-level halos ``scale`` times
        wider (``models.common.halo_clone``; JAX's, ``sph3d_gcn_tpu/train/
        steps.py:208-222``): the first re-run of a batch whose only breach
        was a halo (``halo_ok`` False), which stays sharded, so no rank
        ever holds the whole cloud's activations. Returns ``self``
        without point sharding."""
        if self.points is None:
            return self
        return dataclasses.replace(self, model=halo_clone(self.model, scale))

    def classic_fallback(self) -> StepFactory:
        """A StepFactory on the SAME parameters, BN buffers, optimizer and
        scheduler whose model runs the per-edge engine
        (``models.common.classic_clone``): the recovery path for a batch
        whose dense certificate failed, exact for every cloud
        (``sph3d_gcn_tpu/train/steps.py:227-270``). The clone keeps the
        config's sampling, pooling and unpooling options. Under point
        sharding it runs unsharded (the per-edge engine has none): each
        point rank runs its replica's rows whole, the data group's
        all-reduce alone summing the gradients, so the whole cloud's
        activations must fit one card (JAX's memory bound; ``fit`` tries
        :meth:`halo_widened` first where the halos alone failed). Returns
        ``self`` when the model already runs it."""
        model = classic_clone(self.model)
        if model is self.model:
            return self
        return dataclasses.replace(self, model=model, points=None)

    def eval_step(self, batch: dict[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor]:
        """The eval-mode forward and losses (running BN statistics, no
        dropout, no gradient). Under a group ``batch`` is this replica's
        rows, and ``logits`` and ``item_loss`` come back for the whole
        global batch (all-gathered in rank order), ``loss``, ``data_loss``,
        ``dense_ok`` and ``halo_ok`` the global batch's."""
        self.model.eval()
        with torch.no_grad():
            total, data_loss, logits = self._losses(batch, None)
            item_loss = (None if self.item_loss_fn is None
                         else self.item_loss_fn(logits, batch))
            ok, halo_ok = self.model.dense_ok, self._halo_ok()
            if self._spread():
                total, data_loss, ok, halo_ok = self._agree(total,
                                                            data_loss)
            if spread(self.group):
                logits = self.group.all_gather_rows(logits)
                if item_loss is not None:
                    item_loss = self.group.all_gather_rows(item_loss)
        out = {"loss": total, "data_loss": data_loss, "logits": logits,
               "dense_ok": ok, "halo_ok": halo_ok}
        if item_loss is not None:
            out["item_loss"] = item_loss
        return out


def classification_step_factory(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    weight_decay: float | None = None,
    use_kernels: bool | None = None,
    group: DataGroup | None = None,
    points: PointGroup | None = None,
) -> StepFactory:
    """StepFactory with the mean softmax-CE classification loss
    (ref SPH3D_modelnet.py:112-119); ``group`` and ``points`` as
    :class:`StepFactory`."""
    from sph3d_gcn_torch.models.modelnet import (
        classification_item_loss,
        classification_loss,
    )

    return StepFactory(
        model=model, optimizer=optimizer, scheduler=scheduler,
        loss_fn=lambda logits, batch: classification_loss(
            logits, batch["label"]),
        weight_decay=weight_decay,
        item_loss_fn=lambda logits, batch: classification_item_loss(
            logits, batch["label"]),
        use_kernels=use_kernels, group=group, loss_reduction="mean",
        points=points,
    )


def segmentation_step_factory(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    weight_decay: float | None = None,
    inner_masked: bool = False,
    use_kernels: bool | None = None,
    model_kwargs_keys: tuple[str, ...] = (),
    group: DataGroup | None = None,
    points: PointGroup | None = None,
) -> StepFactory:
    """StepFactory with the per-point CE loss over ``batch["label"]``
    (B, N): the plain mean, or with ``inner_masked`` the S3DIS / ScanNet
    loss over the inner points ``batch["inner_label"] > 0``, summed over
    the batch's items (ref SPH3D_s3dis.py:116-133). ``model_kwargs_keys``
    names the batch's extra model inputs (``("cls_label",)`` for
    ``SPH3DShapeNetOnehot``); ``group`` and ``points`` as
    :class:`StepFactory`."""
    from sph3d_gcn_torch.models.segmentation import (
        inner_masked_item_loss,
        inner_masked_segmentation_loss,
        segmentation_item_loss,
        segmentation_loss,
    )

    if inner_masked:
        loss_fn = lambda logits, batch: inner_masked_segmentation_loss(
            logits, batch["label"], batch["inner_label"])
        item_loss_fn = lambda logits, batch: inner_masked_item_loss(
            logits, batch["label"], batch["inner_label"])
    else:
        loss_fn = lambda logits, batch: segmentation_loss(
            logits, batch["label"])
        item_loss_fn = lambda logits, batch: segmentation_item_loss(
            logits, batch["label"])
    return StepFactory(
        model=model, optimizer=optimizer, scheduler=scheduler,
        loss_fn=loss_fn, weight_decay=weight_decay,
        item_loss_fn=item_loss_fn, use_kernels=use_kernels,
        model_kwargs_keys=tuple(model_kwargs_keys), group=group,
        loss_reduction="sum" if inner_masked else "mean", points=points,
    )
