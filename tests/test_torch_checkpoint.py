"""The port's checkpoints and config snapshots, and the conv blocks'
rematerialisation (``remat_blocks``).

- ``train.checkpoint.Checkpointer``: save -> restore gives a bitwise
  equal model (parameters and BN statistics), optimizer (Adam moments and
  step, learning rate) and scheduler, and the next step from the restored
  state equals the next step from the saved one, bitwise; an unfinished
  save (a ``.tmp`` file, or a save that fails while writing) never
  becomes the latest epoch; ``max_to_keep``; ``restore_variables`` loads
  the model alone.
- ``config.json`` crosses both ways against the JAX package's
  ``snapshot_config`` / ``load_config_snapshot``: every field equal. A
  JAX snapshot whose JAX-only field holds another value than JAX's
  default raises, naming the field.
- ``remat_blocks``: a ModelNet train step (N=512, the published
  channels, dropout on) on the dense and the per-edge engine with and
  without it gives bitwise equal loss, gradients and BN statistics (the
  backward's recompute does not move the running statistics a second
  time); the S3DIS step's is checked on the card (``chip_smoke.py``
  phase 40).

JAX's side here is its config code alone: nothing is traced.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sph3d_gcn_tpu import configs as jax_configs
from sph3d_gcn_tpu.train.checkpoint import (
    load_config_snapshot as jax_load_config,
)
from sph3d_gcn_tpu.train.checkpoint import snapshot_config as jax_snapshot
from sph3d_gcn_torch import configs
from sph3d_gcn_torch.configs import SPH3DConfig, modelnet_config
from sph3d_gcn_torch.data.synthetic import surface_clouds
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.train.checkpoint import (
    Checkpointer,
    load_config_snapshot,
    snapshot_config,
)
from sph3d_gcn_torch.train.schedule import exponential_decay_lr, make_optimizer
from sph3d_gcn_torch.train.steps import classification_step_factory
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_configs_data import assert_same_config

N = 512


def _factory(seed=0):
    cfg = dataclasses.replace(modelnet_config(num_input=N, fast=True,
                                              dense=True), windows=(512,))
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(seed))
    return classification_step_factory(
        model, *make_optimizer(model.parameters(), "adam",
                               exponential_decay_lr(1e-3, 2, decay_step=2)),
        weight_decay=cfg.weight_decay)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"points": torch.from_numpy(surface_clouds(rng, 2, N)),
            "label": torch.tensor([3, 9])}


def _same(a, b):
    """Bitwise equality of two nested states (tensors, numbers, lists)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b) and a.dtype == b.dtype
    return a == b


def _stepped(seed=0):
    factory = _factory(seed)
    for i in range(2):
        factory.train_step(_batch(i), torch.Generator().manual_seed(i))
    return factory


def test_save_restore_is_bitwise(tmp_path):
    saved = _stepped()
    ckpt = Checkpointer(tmp_path)
    ckpt.save(0, saved.model, saved.optimizer, saved.scheduler, step=2)
    at_save = {k: v.clone() for k, v in saved.model.state_dict().items()}
    got = _factory(seed=1)
    assert not _same(got.model.state_dict(), saved.model.state_dict())
    extra = Checkpointer(tmp_path).restore(got.model, got.optimizer,
                                           got.scheduler)
    assert extra == {"step": 2}
    for a, b in ((got.model, saved.model), (got.optimizer, saved.optimizer),
                 (got.scheduler, saved.scheduler)):
        assert _same(a.state_dict(), b.state_dict()), type(a)
    assert got.optimizer.param_groups[0]["lr"] == 1e-3 * 0.7 ** 2
    for f in (saved, got):
        f.train_step(_batch(5), torch.Generator().manual_seed(5))
    assert _same(got.model.state_dict(), saved.model.state_dict())
    assert _same(got.optimizer.state_dict(), saved.optimizer.state_dict())

    fresh = _factory(seed=2)
    assert Checkpointer(tmp_path).restore_variables(fresh.model) == 0
    assert _same(fresh.model.state_dict(), at_save)
    assert not fresh.optimizer.state


def test_unfinished_saves_are_ignored(tmp_path, monkeypatch):
    factory = _factory()
    ckpt = Checkpointer(tmp_path, max_to_keep=2)
    assert ckpt.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_variables(factory.model)
    for epoch in range(3):
        ckpt.save(epoch, factory.model, factory.optimizer, factory.scheduler)
    assert ckpt.epochs() == [1, 2]
    (tmp_path / "ckpt" / "7.pt.tmp").write_bytes(b"half a file")

    def interrupted(obj, f, *args, **kwargs):
        f.write(b"torn")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", interrupted)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(3, factory.model)
    monkeypatch.undo()
    assert ckpt.latest_epoch() == 2
    assert Checkpointer(tmp_path).restore_variables(factory.model) == 2


@pytest.mark.parametrize("make", [
    lambda m: m.modelnet_config(),
    lambda m: m.modelnet_config(fast=True, dense=True, family="hard"),
    lambda m: m.s3dis_config(),
    lambda m: m.s3dis_config(fast=True),
    lambda m: m.scannet_config(num_input=2048, fast=True, dense=True),
])
def test_config_snapshot_crosses_both_ways(make, tmp_path):
    ours, theirs = make(configs), make(jax_configs)
    snapshot_config(tmp_path / "port", ours)
    assert_same_config(ours, jax_load_config(tmp_path / "port"))
    jax_snapshot(tmp_path / "jax", theirs)
    assert_same_config(load_config_snapshot(tmp_path / "jax"), theirs)
    assert load_config_snapshot(tmp_path / "port") == ours


@pytest.mark.parametrize("field,value", [
    ("mlp2", 64), ("num_parts", 4),
    ("point_axis", "points"), ("data_axis", "data"), ("halo_scale", 2),
    ("not_a_field", 1),
])
def test_unported_jax_fields_raise(field, value, tmp_path):
    jax_snapshot(tmp_path, jax_configs.modelnet_config())
    path = tmp_path / "config.json"
    payload = json.loads(path.read_text())
    assert field == "not_a_field" or field in payload
    payload[field] = value
    path.write_text(json.dumps(payload))
    assert {f.name for f in dataclasses.fields(SPH3DConfig)} < set(payload)
    if field in ("data_axis", "halo_scale"):
        # point sharding is ported: its fields load as they were written
        # (point_axis on this per-edge config raises as JAX's config does:
        # it needs the dense engine)
        assert getattr(load_config_snapshot(tmp_path), field) == value
        return
    with pytest.raises(ValueError, match=field):
        load_config_snapshot(tmp_path)


@pytest.mark.parametrize("dense", [False, True])
def test_remat_blocks_changes_no_gradient_or_statistic(dense):
    cfg = modelnet_config(num_input=N, fast=True, dense=dense)
    if dense:
        cfg = dataclasses.replace(cfg, windows=(512,))
    state0 = _factory().model.state_dict()
    batch = _batch(7)
    out = []
    for remat in (False, True):
        model = SPH3DModelNet(dataclasses.replace(cfg, remat_blocks=remat))
        model.load_state_dict(state0)
        factory = classification_step_factory(model, *make_optimizer(
            model.parameters()), weight_decay=cfg.weight_decay)
        metrics = factory.loss_and_grads(batch,
                                         torch.Generator().manual_seed(3))
        out.append((metrics, {k: p.grad for k, p in
                              model.named_parameters()},
                    model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = out
    assert bool(m0["dense_ok"]) and bool(m1["dense_ok"])
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert any(not torch.equal(s0[k], state0[k]) for k in s0
               if k.startswith("conv") and k.endswith(".mean"))
