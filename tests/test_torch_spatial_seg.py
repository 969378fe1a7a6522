"""PyTorch port vs JAX: the point-sharded scene models on two gloo ranks
and the sharding's config.

One ``parallel.RankPool`` of two CPU ranks (one point group) serves the
file; test_torch_spatial_fit.py holds the re-runs of ``fit`` and eval
and ``--point_devices``.

- The S3DIS inner-masked step sharded two ways (levels 1024 and 256 of
  ``test_spatial.py:487-497``'s config split, 96, 48 and 16 replicated;
  B=2, test_torch_seg_train.py's numpy-seeded weights and batch, f32)
  against JAX's UNSHARDED step (``segmentation_step_factory(...,
  inner_masked=True)``; JAX's own sharded scene test is marked slow),
  at test_torch_seg_train.py's f32 tolerances: loss 1e-5 relative,
  logits 1e-4, each gradient leaf 1e-2 relative L2 (a cancelling decoder
  BN bias) and the median leaf 1e-4, BN statistics 1e-5.
- ``StepFactory.halo_widened`` on ``test_spatial.py:765-814``'s config
  (N=256) doubles ``halo_scale`` and its sharded step equals the port's
  one-process step (loss 1e-5 relative; states as ``_near`` holds them:
  every BN statistic within 1e-5, every parameter within 2 lr, Adam's
  first step moving an entry by about lr and a cancelling gradient
  flipping, all but 1e-3 of the entries within 1e-6), with ``halo_ok``
  True.
- A point group of one gives the unsharded forward bitwise; the CLIs'
  flag checks; a sharded model without its group raises.
- The config's ``point_axis``, ``data_axis`` and ``halo_scale`` through a
  snapshot and a checkpoint, with JAX's names, order and defaults.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_torch.cli import add_parallel_args, setup_parallel, shard_config
from sph3d_gcn_torch.configs import SPH3DConfig, modelnet_config, s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.nn.graph import build_graph_dense
from sph3d_gcn_torch.parallel import PointGroup, RankPool, data_parallel
from sph3d_gcn_torch.train.checkpoint import (
    Checkpointer,
    load_config_snapshot,
    snapshot_config,
)
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import segmentation_step_factory
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax
from test_torch_seg_train import STEP_TOL, _batch, _jax_step, _variables
from test_torch_segmentation import _config

import torch_parallel_workers as PW
import torch_spatial_workers as W
from test_torch_cli import one_torch_thread  # noqa: F401

R = 2
LR, SEED = 1e-3, 5


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(R, timeout=300,
                  store_dir=str(tmp_path_factory.mktemp("store"))) as p:
        yield p


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _scene_spec(cfg, state, **kw):
    return dict(model="scene", config=cfg, lr=LR, inner_masked=True,
                state={k: v.numpy() for k, v in state.items()}, **kw)


def test_s3dis_sharded_step_matches_jax_unsharded_step(pool):
    tol = STEP_TOL["float32"]
    total, data_loss, logits, new_stats, ok, grads = _jax_step("float32")
    model = SPH3DSceneSeg(_config("float32"))
    state = torch_state_dict_from_flax(_variables(), model.state_dict())
    pts, labels, inner = _batch()
    batch = {"points": pts, "label": labels, "inner_label": inner}
    ranks = pool.run(W.sharded_step, _scene_spec(_config("float32"), state),
                     batch, SEED, R)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["loss"] == r0["loss"]
        for k, v in r0["grads"].items():
            np.testing.assert_array_equal(v, r["grads"][k], err_msg=k)
    assert bool(ok) and r0["dense_ok"] and r0["halo_ok"]
    assert _rel(r0["loss"], total) < tol["loss"]
    assert _rel(r0["data_loss"], data_loss) < tol["loss"]
    assert _rel(r0["logits"], logits) < tol["logits"]
    like = {k: torch.from_numpy(v) for k, v in r0["state"].items()}
    ref = {k: v.numpy() for k, v in torch_state_dict_from_flax(
        {"params": grads, "batch_stats": new_stats}, like).items()}
    errs = {k: _rel(g, ref[k]) for k, g in r0["grads"].items()}
    assert max(errs.values()) < tol["grad"], errs
    assert np.median(list(errs.values())) < tol["grad_median"]
    for k, v in r0["state"].items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v, ref[k], rtol=tol["stats"],
                                       atol=tol["stats"], err_msg=k)


def _near(got: dict, want: dict) -> None:
    """Two states after the same Adam steps: BN statistics within 1e-5,
    every parameter within 2 lr, all but 1e-3 of the entries within
    1e-6."""
    loose = entries = 0
    for k, w in want.items():
        err = np.abs(got[k] - w)
        if k.endswith((".mean", ".var")):
            assert err.max() < 1e-5, k
            continue
        assert err.max() <= 2 * LR + 1e-6, k
        loose += int((err > 1e-6).sum())
        entries += err.size
    assert loose <= 1e-3 * entries, (loose, entries)


def _tiny_config(n, windows, **kw):
    return SPH3DConfig(
        num_input=n, num_cls=5, mlp=8, num_sample=(n // 2,),
        radius=(kw.pop("radius", 1.5),), nn_uplimit=(8,),
        channels=((8, 8),), multiplier=((2, 2),), weight_decay=None,
        spatial_sort=True, dense_graph=True, windows=(windows,),
        dec_windows=(windows,), dec_margin=128, growth_steps=6, **kw)


def _random_batch(n, seed, b=2):
    rng = np.random.default_rng(seed)
    return {"points": rng.standard_normal((b, n, 9)).astype(np.float32),
            "label": rng.integers(0, 5, (b, n)).astype(np.int64),
            "inner_label": rng.integers(0, 2, (b, n)).astype(np.int32)}


def test_halo_widened_step_matches_one_process(pool):
    cfg = _tiny_config(256, 256)
    state = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(0)
                          ).state_dict()
    spec, batch = _scene_spec(cfg, state), _random_batch(256, 5)
    ranks = pool.run(W.halo_retry, spec, batch, SEED)
    ref = PW.step_result(PW.build_factory(spec), batch, SEED)
    for r in ranks:
        assert r["scale"] == 2 and r["halo_ok"] and r["wide"]["dense_ok"]
        assert r["first"] == (True, True) and r["eval_wide"] == (True, True)
        assert _rel(r["wide"]["loss"], ref["loss"]) < 1e-5
        _near(r["wide"]["state"], ref["state"])
    np.testing.assert_array_equal(ranks[0]["eval_logits"],
                                  ranks[1]["eval_logits"])


def _scene_batch(seed):
    rng = np.random.default_rng(seed)
    return {"points": scene_blocks(rng, 2, 1024).astype(np.float32),
            "label": rng.integers(0, 5, (2, 1024)).astype(np.int64),
            "inner_label": rng.integers(0, 2, (2, 1024)).astype(np.int32)}


@pytest.mark.parametrize("argv,match", [
    (["--point_devices", "2"], "launch the ranks under torchrun"),
    (["--num_devices", "2", "--point_devices", "2"],
     "launch the ranks under torchrun"),
])
def test_point_devices_need_a_launcher(argv, match):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    add_parallel_args(parser)
    with pytest.raises(ValueError, match=match):
        setup_parallel(parser.parse_args(argv))


def test_shard_config_needs_the_dense_engine():
    points = PointGroup(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="--mode dense"):
        shard_config(modelnet_config(), None, points)
    cfg = shard_config(modelnet_config(fast=True, dense=True), None, points)
    assert (cfg.point_axis, cfg.data_axis) == ("points", None)
    assert shard_config(cfg, None, None) is cfg
    with pytest.raises(ValueError, match="dense windowed engine"):
        dataclasses.replace(modelnet_config(), point_axis="points")


def test_a_sharded_model_needs_its_point_group():
    cfg = dataclasses.replace(_tiny_config(256, 256), point_axis="points")
    model = SPH3DSceneSeg(cfg)
    with pytest.raises(ValueError, match="needs a point group"):
        model(torch.zeros(1, 256, 9))
    opt, sch = make_optimizer(model.parameters(), "adam", LR)
    with pytest.raises(ValueError, match="set both or neither"):
        segmentation_step_factory(model, opt, sch, inner_masked=True)
    plain = SPH3DSceneSeg(dataclasses.replace(cfg, point_axis=None))
    opt, sch = make_optimizer(plain.parameters(), "adam", LR)
    points = PointGroup(rank=0, size=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="set both or neither"):
        segmentation_step_factory(plain, opt, sch, points=points)


def test_a_point_group_of_one_is_the_unsharded_forward():
    cfg = _tiny_config(256, 256)
    gen = torch.Generator().manual_seed(2)
    model = SPH3DSceneSeg(dataclasses.replace(cfg, point_axis="points"),
                          generator=gen).eval()
    plain = SPH3DSceneSeg(cfg).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(_random_batch(256, 3)["points"])
    points = PointGroup(rank=0, size=1, device=torch.device("cpu"))
    with torch.no_grad(), data_parallel(None, points):
        got = model(x)
    with torch.no_grad():
        want = plain(x)
    assert bool(model.dense_ok) and bool(model.halo_ok)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ids_sampling_does_not_shard():
    pts = torch.rand(1, 256, 3)
    with pytest.raises(ValueError, match="IDS sampling"):
        build_graph_dense(pts, 0.3, 8, 128, "IDS", window=256,
                          query_shard=(0, 2))


def test_point_sharding_config_round_trips(tmp_path):
    cfg = dataclasses.replace(s3dis_config(fast=True, dense=True),
                              point_axis="points", data_axis="data",
                              halo_scale=2)
    snapshot_config(tmp_path, cfg)
    assert load_config_snapshot(tmp_path) == cfg
    model = SPH3DSceneSeg(dataclasses.replace(cfg, num_input=1024))
    Checkpointer(tmp_path).save(0, model, step=3)
    again = SPH3DSceneSeg(dataclasses.replace(cfg, num_input=1024))
    assert Checkpointer(tmp_path).restore_variables(again) == 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)
    # JAX's field names, defaults and order
    jax_fields = [f.name for f in dataclasses.fields(jax_s3dis_config())]
    ours = [f.name for f in dataclasses.fields(SPH3DConfig)]
    assert [f for f in jax_fields if f in ours] == ours
    for name in ("point_axis", "data_axis", "halo_scale"):
        assert getattr(s3dis_config(), name) == \
            getattr(jax_s3dis_config(), name)
