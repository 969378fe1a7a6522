"""Rank functions of the data-parallel tests (``test_torch_parallel*``),
run by ``sph3d_gcn_torch.parallel.run_ranks`` in spawned processes. This
module imports the port only (no JAX), so that a spawned rank starts
fast; each function takes the rank's ``DataGroup`` first."""

from __future__ import annotations

import numpy as np
import torch

from sph3d_gcn_torch.parallel import shard_batch
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import (
    classification_step_factory,
    segmentation_step_factory,
)


def narrow_modelnet_spec(windows=(512,), **config) -> dict:
    """A spec of a one-level dense ModelNet classifier at N=512 with
    narrow widths, f32, dropout on, seeded weights."""
    import dataclasses

    from sph3d_gcn_torch.configs import modelnet_config
    from sph3d_gcn_torch.models import SPH3DModelNet

    cfg = dataclasses.replace(
        modelnet_config(num_input=512, fast=True, dense=True),
        windows=windows, compute_dtype="float32", mlp=8,
        channels=((16, 16),), multiplier=((1, 1),), global_channels=32,
        global_multiplier=1, **config)
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    return dict(model="modelnet", config=cfg, lr=1e-3,
                weight_decay=cfg.weight_decay,
                state={k: v.numpy() for k, v in model.state_dict().items()})


def build_factory(spec: dict, group=None):
    """A step factory from a picklable ``spec``: ``model`` ('modelnet' or
    'scene'), ``config``, ``state`` (numpy state dict), ``lr``, and
    ``weight_decay`` / ``inner_masked``."""
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg

    cls = SPH3DModelNet if spec["model"] == "modelnet" else SPH3DSceneSeg
    model = cls(spec["config"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()})
    opt, sch = make_optimizer(model.parameters(), "adam", spec["lr"])
    if spec["model"] == "modelnet":
        return classification_step_factory(
            model, opt, sch, weight_decay=spec.get("weight_decay"),
            group=group)
    return segmentation_step_factory(
        model, opt, sch, weight_decay=spec.get("weight_decay"),
        inner_masked=spec.get("inner_masked", False), group=group)


def step_result(factory, batch: dict, seed: int) -> dict:
    """One train step on ``batch`` (numpy, this rank's rows) with the
    generator of ``seed``: the metrics, every gradient, and the model's
    state after the update, as numpy."""
    metrics = factory.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(seed))
    model = factory.model
    return {
        "loss": float(metrics["loss"]),
        "data_loss": float(metrics["data_loss"]),
        "dense_ok": bool(metrics["dense_ok"]),
        "logits": metrics["logits"].float().numpy(),
        "grads": {k: p.grad.numpy().copy()
                  for k, p in model.named_parameters()},
        "state": {k: v.numpy().copy()
                  for k, v in model.state_dict().items()},
    }


def train_step(group, spec: dict, batch: dict, seed: int) -> dict:
    """:func:`step_result` of this rank's rows of the global ``batch``."""
    return step_result(build_factory(spec, group), shard_batch(batch, group),
                       seed)


def batch_norm(group, x: np.ndarray, ct: np.ndarray, steps: int = 1,
               frozen: bool = False) -> dict:
    """A train-mode ``BatchNorm`` on this rank's rows of ``x`` under
    ``data_parallel`` (and ``frozen_running_stats`` if ``frozen``),
    ``steps`` times: its output, the input's and the parameters'
    gradients for the cotangent rows of ``ct``, and the running
    statistics."""
    import contextlib

    from sph3d_gcn_torch.nn.layers import BatchNorm, frozen_running_stats
    from sph3d_gcn_torch.parallel import data_parallel

    bn = BatchNorm(x.shape[-1])
    xs = torch.from_numpy(group.local_rows(x) if group else x)
    cts = torch.from_numpy(group.local_rows(ct) if group else ct)
    for _ in range(steps):
        xs.grad = None
        bn.zero_grad()
        xs.requires_grad_(True)
        with data_parallel(group), (frozen_running_stats() if frozen
                                    else contextlib.nullcontext()):
            out = bn(xs)
        (out * cts).sum().backward()
    grads = {k: p.grad.clone() for k, p in bn.named_parameters()}
    if group is not None:
        for g in grads.values():
            group.all_reduce_(g)
    return {"out": out.detach().numpy(), "dx": xs.grad.numpy(),
            **{f"d{k}": g.numpy() for k, g in grads.items()},
            "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def collectives(group) -> dict:
    """The group's sums, gather and barrier, and whether a step's
    collectives are on (:func:`parallel.spread`)."""
    from sph3d_gcn_torch.parallel import spread

    rows = torch.full((2, 3), float(group.rank))
    group.barrier()
    return {"sums": group.sum_floats(1.0, group.rank),
            "gathered": group.all_gather_rows(rows).numpy(),
            "spread": spread(group)}


def stall(group) -> None:
    """Rank 0 waits in a collective that rank 1 never reaches."""
    if group.rank == 0:
        group.barrier()
    else:
        import time
        time.sleep(600)


def fail(group) -> None:
    if group.rank == 1:
        raise ValueError("rank 1 fails")
    group.barrier()


def remat_equal(group, spec: dict, batch: dict, seed: int) -> dict:
    """This rank's step on its rows of ``batch`` with ``spec``'s conv
    blocks recomputed in the backward (``remat_blocks``) and without:
    whether loss, gradients and state are bitwise equal."""
    import dataclasses

    rows = shard_batch(batch, group)
    remat = dict(spec, config=dataclasses.replace(spec["config"],
                                                  remat_blocks=True))
    a = step_result(build_factory(remat, group), rows, seed)
    b = step_result(build_factory(spec, group), rows, seed)
    return {"loss": a["loss"] == b["loss"],
            **{key: all(np.array_equal(v, b[key][k])
                        for k, v in a[key].items())
               for key in ("grads", "state")}}


def world_one(group, spec: dict, batch: dict, seed: int) -> dict:
    """One step in a group of one rank and one without a group, from the
    same state: whether loss, gradients and state are bitwise equal."""
    grouped = step_result(build_factory(spec, group), batch, seed)
    alone = step_result(build_factory(spec), batch, seed)
    return {"loss": grouped["loss"] == alone["loss"]
            and grouped["data_loss"] == alone["data_loss"],
            "grads": all(np.array_equal(v, alone["grads"][k])
                         for k, v in grouped["grads"].items()),
            "state": all(np.array_equal(v, alone["state"][k])
                         for k, v in grouped["state"].items()),
            "logits": np.array_equal(grouped["logits"], alone["logits"])}


def fit_runs(group, spec: dict, train: list[dict], evals: list[dict],
             batch_size: int, log_dir: str, seed: int) -> dict:
    """``train.loop.fit`` on the global batches (each rank steps on its
    rows), the eval passes on BN statistics primed over one batch: two epochs
    straight (``log_dir/straight``) and one epoch then a resume to two
    (``log_dir/resumed``). Returns both final states, what the rank
    printed and how many files it saved."""
    import contextlib
    import io
    import os

    import sph3d_gcn_torch.train.checkpoint as checkpoint
    from sph3d_gcn_torch.train.loop import fit

    saves = []
    real_save = checkpoint.torch.save

    def save(obj, f):
        saves.append(1)
        real_save(obj, f)

    checkpoint.torch.save = save
    printed = io.StringIO()
    states = {}
    with contextlib.redirect_stdout(printed):
        for name, epochs in (("straight", (2,)), ("resumed", (1, 2))):
            for num in epochs:
                model = fit(build_factory(spec, group),
                            lambda epoch: iter(train),
                            lambda: iter(evals), batch_size, num,
                            os.path.join(log_dir, name), seed=seed,
                            bn_prime_steps=1)
            states[name] = {k: v.numpy().copy()
                            for k, v in model.state_dict().items()}
    checkpoint.torch.save = real_save
    return {"states": states, "printed": printed.getvalue(),
            "saves": len(saves)}


def certificate(group, spec: dict, batch: dict, seed: int) -> dict:
    """This rank's own certificate on its rows (an eval forward without
    the group), then the step's under the group."""
    factory = build_factory(spec, group)
    rows = shard_batch(batch, group)
    with torch.no_grad():
        factory.model.eval()(torch.from_numpy(rows["points"]))
    own = bool(factory.model.dense_ok)
    out = step_result(factory, rows, seed)
    return {"own": own, "step": out["dense_ok"]}


def fit_fallback(group, spec: dict, batch: dict, log_dir: str, seed: int
                 ) -> dict:
    """One epoch of ``fit`` on the global ``batch`` (train and eval; each
    rank steps on its rows): the final state."""
    from sph3d_gcn_torch.train.loop import fit

    model = fit(build_factory(spec, group), lambda epoch: iter([batch]),
                lambda: iter([batch]), len(batch["label"]), 1, log_dir,
                seed=seed)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def cli_main(group, module: str, argv: list[str]) -> dict:
    """``sph3d_gcn_torch.cli.<module>.main(argv)`` on this rank: the
    train entry points' final state, the evaluate ones' votes and
    forward counts."""
    import importlib

    out = importlib.import_module(f"sph3d_gcn_torch.cli.{module}").main(argv)
    if isinstance(out, torch.nn.Module):
        return {k: v.numpy().copy() for k, v in out.state_dict().items()}
    return {"votes": out["votes"], "forwards": out["forwards"],
            "reruns": out["reruns"]}


def eval_paths(group, spec: dict, batch: dict) -> dict:
    """``checked_forward`` under ``vote_classify`` (2 votes) and
    ``checked_eval_step`` on ``batch`` (every rank holds it whole): the
    votes, the eval logits, and whether each re-ran on the per-edge
    engine."""
    import contextlib
    import io

    from sph3d_gcn_torch.train.eval import (
        checked_eval_step,
        checked_forward,
        vote_classify,
    )

    factory = build_factory(spec, group)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        forward = checked_forward(factory.model.eval(), "cpu",
                                  generator=torch.Generator(), group=group)
        votes = vote_classify(forward, batch["points"], 2,
                              np.random.default_rng(4))
        metrics = checked_eval_step(factory)(
            {k: torch.from_numpy(v) for k, v in shard_batch(batch,
                                                            group).items()})
    return {"votes": votes, "logits": metrics["logits"].numpy(),
            "item_loss": metrics["item_loss"].numpy(),
            "loss": float(metrics["loss"]), "printed": printed.getvalue()}


def odd_forwards(group, spec: dict, batch: dict) -> dict:
    """``checked_forward`` on the first item of ``batch`` and on all of it
    (batches that do not split over two ranks): the logits."""
    from sph3d_gcn_torch.train.eval import checked_forward

    factory = build_factory(spec, group)
    forward = checked_forward(factory.model.eval(), "cpu",
                              generator=torch.Generator(), group=group)
    return {"one": forward(batch["points"][:1]),
            "all": forward(batch["points"])}


def write_modelnet_records(d, split: str, files: int) -> None:
    """``files`` ModelNet record files of two seeded 512-point clouds each
    under ``d`` and their list ``{split}_files.txt``, as
    ``cli.train_modelnet`` reads them."""
    from pathlib import Path

    from sph3d_gcn_torch.data.synthetic import surface_clouds
    from sph3d_gcn_torch.data.tfrecord import TFRecordWriter

    paths = []
    for i in range(files):
        rng = np.random.default_rng(10 * i + (split == "test"))
        pts = surface_clouds(rng, 2, 512).astype(np.float32)
        labels = rng.integers(0, 40, 2).astype(np.int32)
        paths.append(str(Path(d) / f"{split}{i}.tfrecord"))
        with TFRecordWriter(paths[-1]) as w:
            for c, lbl in zip(pts, labels):
                w.write_example({"xyz_raw": c[:, [0, 2, 1]].tobytes(),
                                 "label": np.int64(lbl)})
    (Path(d) / f"{split}_files.txt").write_text("\n".join(paths) + "\n")
