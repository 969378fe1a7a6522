"""Rank functions of the point-sharding tests (``test_torch_spatial*``),
run on the ranks of a ``sph3d_gcn_torch.parallel.RankPool`` in spawned
processes. This module imports the port only (no JAX), so that a rank
starts fast; each function takes the rank's world ``DataGroup`` first
and forms its point (and data) groups with ``parallel.split_groups``,
once for each layout."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph3d_gcn_torch.parallel import split_groups
from sph3d_gcn_torch.parallel import spatial

_GROUPS: dict = {}


def groups(world, point_devices: int):
    """This rank's (data group, point group) for ``point_devices``
    (formed once a layout: every rank forms every group)."""
    if point_devices not in _GROUPS:
        _GROUPS[point_devices] = split_groups(world, point_devices)
    return _GROUPS[point_devices]


def _local(x: np.ndarray, pts) -> torch.Tensor:
    return spatial.slice_rows_local(torch.from_numpy(x), pts).clone()


def exchange(world, cases: list[tuple[np.ndarray, np.ndarray, int]]
             ) -> list[dict]:
    """Per case (x (B, R*n, C), y (B, R*(n + 2 halo), C), halo) on R point
    ranks: this rank's ``halo_exchange`` of its rows of x, its
    ``halo_reduce`` of its block of y, the gradient of <exchange(x), y>
    with respect to its rows of x and that of <x, reduce(y)> with respect
    to its block of y."""
    _, pts = groups(world, world.size)
    out = []
    for x, y, halo in cases:
        xs = _local(x, pts).requires_grad_(True)
        blk = y.shape[1] // pts.size
        ys = torch.from_numpy(
            y[:, pts.rank * blk:(pts.rank + 1) * blk].copy()
        ).requires_grad_(True)
        ex = spatial.halo_exchange(xs, halo, pts)
        (ex * ys.detach()).sum().backward()
        red = spatial.halo_reduce(ys, halo, pts)
        (red * xs.detach()).sum().backward()
        out.append({"exchange": ex.detach().numpy(),
                    "reduce": red.detach().numpy(),
                    "dx": xs.grad.numpy(), "dy": ys.grad.numpy()})
    return out


def gathered(world, x: np.ndarray, w: np.ndarray) -> dict:
    """psum_replicated(sum(sin(all_rows(x_rows)) * w) / R): the value and
    this rank's gradient of its rows of x (the true gradient of the
    replicated loss if both transposes are right)."""
    _, pts = groups(world, world.size)
    xs = _local(x, pts).requires_grad_(True)
    full = spatial.all_rows(xs, pts)
    loss = spatial.psum_replicated(
        (torch.sin(full) * torch.from_numpy(w)).sum() / pts.size, pts)
    loss.backward()
    return {"full": full.detach().numpy(), "loss": loss.item(),
            "dx": xs.grad.numpy()}


def sharded_op(world, op: str, db: np.ndarray, query: np.ndarray,
               feats: np.ndarray, graph: dict, halo_blocks: int,
               filt: np.ndarray | None = None) -> dict:
    """A dense op on this rank's query tiles with haloed database rows:
    the graph built on the whole clouds with ``graph``'s arguments, its
    tiles localized (``localize_tiles``) for a halo of ``halo_blocks``
    blocks, the features exchanged; and the same tiles built by the
    sharded query (``query_shard``). Returns this rank's output rows,
    ``shard_ok``, whether the sharded build's maps equal the localized
    tiles, and the gradients of sum(sin(out)) for its feature rows (and
    the conv's filter)."""
    from sph3d_gcn_torch.ops.dense import (
        build_dense_graph,
        dense_depthwise_conv3d,
        dense_max_pool3d,
        dense_weighted_interpolate,
    )

    _, pts = groups(world, world.size)
    dbt, qt = torch.from_numpy(db), torch.from_numpy(query)
    dnbh = spatial.pad_count_for_sharding(
        build_dense_graph(dbt, qt, **graph), pts.size)
    local, shard_ok = spatial.localize_tiles(
        dnbh, pts.rank, pts.size, halo_blocks,
        db.shape[1] // 128 // pts.size)
    tiles, _ = spatial.localize_tiles(dnbh, pts.rank, pts.size, None)
    own = build_dense_graph(dbt, qt, query_shard=(pts.rank, pts.size),
                            **graph)
    same = {k: torch.equal(getattr(own, k), getattr(tiles, k))
            for k in ("packed", "s_blk", "count")}
    same["dist"] = own.dist is None or torch.equal(own.dist, tiles.dist)
    xs = _local(feats, pts).requires_grad_(True)
    # the pool runs in bf16 (its features are bf16 values)
    fw = spatial.halo_exchange(xs.bfloat16() if op == "pool" else xs,
                               halo_blocks * 128, pts)
    inputs = [xs]
    if op == "conv":
        ft = torch.from_numpy(filt).requires_grad_(True)
        inputs.append(ft)
        out = dense_depthwise_conv3d(fw, ft, local)
    elif op == "pool":
        out = dense_max_pool3d(fw, local, with_index=False)[0]
    else:
        out = dense_weighted_interpolate(fw, local)
    torch.sin(out.float()).sum().backward()
    return {"out": out.detach().float().numpy(), "shard_ok": bool(shard_ok),
            "same": same, "grads": [t.grad.float().numpy() for t in inputs]}


def build_factory(spec: dict, world, point_devices: int):
    """A point-sharded step factory from a picklable ``spec`` (as
    ``torch_parallel_workers.build_factory``'s), its config's
    ``point_axis`` set, on this rank's groups."""
    from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
    from sph3d_gcn_torch.parallel import spread
    from sph3d_gcn_torch.train.schedule import make_optimizer
    from sph3d_gcn_torch.train.steps import (
        classification_step_factory,
        segmentation_step_factory,
    )

    data, pts = groups(world, point_devices)
    cfg = dataclasses.replace(
        spec["config"], point_axis="points",
        data_axis="data" if spread(data) else None)
    cls = SPH3DModelNet if spec["model"] == "modelnet" else SPH3DSceneSeg
    model = cls(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()})
    opt, sch = make_optimizer(model.parameters(), "adam", spec["lr"])
    if spec["model"] == "modelnet":
        return classification_step_factory(
            model, opt, sch, weight_decay=spec.get("weight_decay"),
            group=data, points=pts)
    return segmentation_step_factory(
        model, opt, sch, weight_decay=spec.get("weight_decay"),
        inner_masked=spec.get("inner_masked", False), group=data,
        points=pts)


def sharded_step(world, spec: dict, batch: dict, seed: int,
                 point_devices: int) -> dict:
    """One point-sharded train step on this rank's replica rows of the
    global ``batch``: ``torch_parallel_workers.step_result`` and
    ``halo_ok``."""
    from torch_parallel_workers import step_result

    factory = build_factory(spec, world, point_devices)
    data = factory.group
    rows = {k: data.local_rows(v) for k, v in batch.items()}
    out = step_result(factory, rows, seed)
    out["halo_ok"] = bool(factory.model.halo_ok)
    return out


def halo_retry(world, spec: dict, batch: dict, seed: int) -> dict:
    """A train step and an eval step at ``spec``'s config (whose
    inter-level halos breach at 1x) and through ``halo_widened()``: the
    certificates of each, the widened step's result and the halo scale
    it ran at."""
    from torch_parallel_workers import step_result

    factory = build_factory(spec, world, world.size)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    first = factory.train_step(tb, torch.Generator().manual_seed(seed))
    ev = factory.eval_step(tb)
    wide = build_factory(spec, world, world.size).halo_widened()
    out = step_result(wide, batch, seed)
    ev_wide = wide.eval_step(tb)
    return {"first": (bool(first["dense_ok"]), bool(first["halo_ok"])),
            "eval": (bool(ev["dense_ok"]), bool(ev["halo_ok"])),
            "eval_wide": (bool(ev_wide["dense_ok"]),
                          bool(ev_wide["halo_ok"])),
            "eval_logits": ev_wide["logits"].numpy(),
            "scale": wide.model.config.halo_scale,
            "wide": out, "halo_ok": bool(wide.model.halo_ok)}


def fit_recovery(world, spec: dict, batch: dict, log_dir: str,
                 seed: int) -> dict:
    """One epoch of ``train.loop.fit`` (a train and an eval pass) on the
    global ``batch``: the final state and what rank 0 logged."""
    import contextlib
    import io

    from sph3d_gcn_torch.train.loop import fit

    factory = build_factory(spec, world, world.size)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        model = fit(factory, lambda epoch: iter([batch]),
                    lambda: iter([batch]), len(batch["label"]), 1, log_dir,
                    seed=seed)
    return {"state": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()},
            "printed": printed.getvalue()}


def cli_main(world, module: str, argv: list[str]) -> dict:
    """``sph3d_gcn_torch.cli.<module>.main(argv)`` on this rank (its
    group joined already): the train entry points' final state."""
    import importlib

    out = importlib.import_module(f"sph3d_gcn_torch.cli.{module}").main(argv)
    return {k: v.numpy().copy() for k, v in out.state_dict().items()}


def narrow_inter_halos() -> None:
    """Make this rank's scene models exchange inter-level (pool, unpool)
    halos of one block at ``halo_scale`` 1, narrower than their windows,
    so that a step breaches its halos only; ``halo_scale`` 2 (the
    ``halo_widened`` re-run) runs the models' own halos. For the tests of
    ``fit``'s halo re-run."""
    import sph3d_gcn_torch.models.segmentation as seg

    real = seg.shard_inputs

    def narrow(net, inter, xyz_db, pts, db_sh, q_sh, halo_scale):
        if halo_scale == 1 and db_sh and q_sh:
            inter, ok = spatial.local_neighborhood(
                inter, pts.rank, 1, xyz_db.shape[1] // 128 // pts.size)
            return spatial.halo_exchange(net, 128, pts), inter, ok
        return real(net, inter, xyz_db, pts, db_sh, q_sh, halo_scale)

    seg.shard_inputs = narrow


def fit_narrow_halos(world, spec: dict, batch: dict, log_dir: str,
                     seed: int) -> dict:
    """:func:`fit_recovery` with the inter-level halos narrowed
    (:func:`narrow_inter_halos`) for the run, restored after."""
    import sph3d_gcn_torch.models.segmentation as seg

    real = seg.shard_inputs
    narrow_inter_halos()
    try:
        return fit_recovery(world, spec, batch, log_dir, seed)
    finally:
        seg.shard_inputs = real


def eval_narrow_halos(world, spec: dict, batch: dict) -> dict:
    """``checked_eval_step`` and ``checked_forward`` on ``batch`` with the
    inter-level halos narrowed (:func:`narrow_inter_halos`): the logits
    of each, the eval step's re-runs and what rank 0 printed."""
    import contextlib
    import io

    import sph3d_gcn_torch.models.segmentation as seg
    from sph3d_gcn_torch.train.eval import checked_eval_step, checked_forward

    factory = build_factory(spec, world, world.size)
    real = seg.shard_inputs
    narrow_inter_halos()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            run = checked_eval_step(factory)
            metrics = run({k: torch.from_numpy(v) for k, v in batch.items()})
            forward = checked_forward(
                factory.model.eval(), "cpu", generator=torch.Generator(),
                group=factory.group, points=factory.points)
            logits = forward(batch["points"])
    finally:
        seg.shard_inputs = real
    return {"eval_logits": metrics["logits"].numpy(),
            "dense_ok": bool(metrics["dense_ok"]),
            "reruns": dict(run.reruns), "forward_logits": logits,
            "printed": printed.getvalue()}
