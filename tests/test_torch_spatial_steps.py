"""PyTorch port vs JAX: point-sharded train steps on four gloo ranks.

One ``parallel.RankPool`` of four CPU ranks serves the file.

- The ModelNet dense step sharded four ways against JAX's sharded step
  (``classification_step_factory(..., mesh=('points',) x 4,
  point_axis='points')``, ``shard_map`` over four virtual CPU devices):
  ``tests/test_spatial.py:565-631``'s config (``modelnet_config(
  num_input=1024, fast=True, dense=True)``, windows (768,), f32; level 0's
  8 tiles split 2 a rank, the 256-point level, the global conv and the
  head replicated), B=2, numpy-seeded weights carried across by
  ``utils.convert``, weight decay 0.05 and dropout on: the port draws its
  masks from a seeded generator and a flax interceptor applies the same
  masks on JAX's side. JAX's own test held the sharded step to the
  unsharded one at loss 2e-3, logits 5e-2 and parameters 5e-3; the port
  is held at loss 5e-5, logits 2e-4 relative and an unresolved share of
  1e-2 (``TOL_MN``: this config's f32 logits move ~1e-4 between summation
  orders, and its one-process step reads as far from JAX's) and otherwise
  at test_torch_parallel_modelnet.py's data-parallel tolerances (each
  gradient leaf 2e-3 relative L2, BN statistics 1e-5, the Adam update's
  resolved entries within lr * 0.1 / 4 + 1e-7 and the rest under 1e-3
  of the entries). The four ranks end bitwise alike.
- The S3DIS inner-masked step on a composed 2 x 2 layout (two replicas
  of two point ranks; rank r holds data index r // 2 and point index
  r % 2) against the port's one-process step on the global batch (B=4,
  N=1024, test_torch_segmentation.py's config in f32, seeded weights,
  weight decay 0.05): loss and data loss 1e-5, logits 1e-4, each
  gradient leaf 2e-3 of the larger of its norm and the median leaf's,
  BN statistics 1e-5 and the Adam update as above. The one-process step
  is held against JAX's in test_torch_seg_train.py.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_tpu.parallel.mesh import replicated
from sph3d_gcn_tpu.train.steps import (
    TrainState,
    classification_step_factory as jax_step_factory,
)
from sph3d_gcn_torch.configs import modelnet_config
from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
from sph3d_gcn_torch.parallel import RankPool
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax
from test_torch_segmentation import _config as _scene_config

import torch_parallel_workers as PW
import torch_spatial_workers as W
from test_torch_cli import one_torch_thread  # noqa: F401

R = 4
LR, DECAY, SEED = 1e-3, 0.05, 11
TOL = dict(loss=1e-5, logits=1e-4, grad=2e-3, stats=1e-5, resolved=0.1,
           unresolved_share=1e-3)
# this ModelNet config's f32 logits move ~1e-4 between any two summation
# orders (the port's one-process step reads 2.0e-4 against JAX's sharded
# step, its own sharded step 1.5e-4 against it), and 0.4-0.6% of its
# gradient entries by more than 10% (3.9e-3 and 5.9e-3 of the entries):
# loss 5e-5, logits 2e-4 and an unresolved share of 1e-2 (measured
# 1.9e-5, 7.6e-5 and 3.5e-3 against JAX's sharded step)
TOL_MN = dict(TOL, loss=5e-5, logits=2e-4, unresolved_share=1e-2)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(R, timeout=240,
                  store_dir=str(tmp_path_factory.mktemp("store"))) as p:
        yield p


def _mn_config(factory=modelnet_config, **kw):
    return dataclasses.replace(
        factory(num_input=1024, fast=True, dense=True), windows=(768,),
        compute_dtype="float32", **kw)


def _mn_batch():
    rng = np.random.default_rng(5)
    return {"points": surface_clouds(rng, 2, 1024).astype(np.float32),
            "label": np.array([3, 17], np.int32)}


def _fill(shapes, seed: int):
    """A variable tree of ``shapes`` with numpy-seeded values: He-scaled
    weights, BN terms near 1 / 0."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("weights", "depthwise_weights"):
            fan = s.shape[-2] * int(np.prod(s.shape[:-2]))
            return rng.standard_normal(s.shape).astype(np.float32) \
                * np.float32(np.sqrt(2.0 / fan))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _jax_modelnet_run():
    batch = _mn_batch()
    variables = _fill(jax.eval_shape(
        lambda p: JaxModelNet(_mn_config(jax_modelnet_config)).init(
            jax.random.key(0), p), batch["points"]), 1)
    mesh = Mesh(np.array(jax.devices()[:R]), ("points",))
    sf = jax_step_factory(
        JaxModelNet(_mn_config(jax_modelnet_config, point_axis="points")),
        optax.adam(LR), weight_decay=DECAY, mesh=mesh, point_axis="points")
    state = jax.device_put(TrainState.create(variables, sf.tx),
                           replicated(mesh))
    gen = torch.Generator().manual_seed(SEED)
    keep = {name: (torch.rand((2, width), generator=gen) < 0.5).numpy()
            for name, width in (("fc1_dp", 512), ("fc2_dp", 256))}

    def dropout(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args, **kwargs)
        x = args[0]
        return jnp.where(jnp.asarray(keep[context.module.name]), x / 0.5,
                         jnp.zeros_like(x))

    with fnn.intercept_methods(dropout):
        new_state, metrics = sf.train_step(donate=False)(
            state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                         new_state.opt_state[0].mu)
    return variables, new_state, metrics, grads


@pytest.fixture(scope="module")
def modelnet_runs(pool):
    variables, new_state, metrics, grads = _jax_modelnet_run()
    model = SPH3DModelNet(_mn_config())
    state = torch_state_dict_from_flax(variables, model.state_dict())
    spec = dict(model="modelnet", config=_mn_config(), lr=LR,
                weight_decay=DECAY,
                state={k: v.numpy() for k, v in state.items()})
    ranks = pool.run(W.sharded_step, spec, _mn_batch(), SEED, R)
    return new_state, metrics, grads, ranks


def test_modelnet_ranks_stay_replicated(modelnet_runs):
    ranks = modelnet_runs[3]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
        for key in ("grads", "state"):
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(v, r[key][k], err_msg=k)
    assert all(r["dense_ok"] and r["halo_ok"] for r in ranks)


def test_modelnet_sharded_step_matches_jax_sharded_step(modelnet_runs):
    new_state, metrics, grads, ranks = modelnet_runs
    assert bool(metrics["halo_ok"])
    assert bool(metrics["dense_ok"])
    # every point rank holds the whole batch's logits: hold one, in the
    # port's state-dict names
    r0 = ranks[0]

    def named(tree):
        like = {k: torch.from_numpy(v) for k, v in r0["state"].items()}
        return {k: v.numpy() for k, v in torch_state_dict_from_flax(
            jax.tree.map(np.asarray, tree), like).items()}

    ref = {"loss": float(metrics["loss"]),
           "data_loss": float(metrics["data_loss"]), "dense_ok": True,
           "logits": np.asarray(metrics["logits"]),
           "grads": {k: v for k, v in named(
               {"params": grads,
                "batch_stats": new_state.batch_stats}).items()
               if k in r0["grads"]},
           "state": named({"params": new_state.params,
                           "batch_stats": new_state.batch_stats})}
    hold_step(r0, ref, TOL_MN)


def _rel(got, ref) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / max(np.linalg.norm(np.asarray(ref, np.float64)), 1e-30))


def hold_step(got: dict, ref: dict, tol: dict) -> None:
    """A sharded step's result against the one-process step's (both
    ``torch_parallel_workers.step_result``)."""
    assert got["dense_ok"] and ref["dense_ok"]
    assert _rel(got["loss"], ref["loss"]) < tol["loss"]
    assert _rel(got["data_loss"], ref["data_loss"]) < tol["loss"]
    assert _rel(got["logits"], ref["logits"]) < tol["logits"]
    med = np.median([np.linalg.norm(v) for v in ref["grads"].values()])
    for k, g in ref["grads"].items():
        err = np.linalg.norm(got["grads"][k] - g)
        assert err <= tol["grad"] * max(np.linalg.norm(g), med), k
    unresolved = entries = 0
    for k, want in ref["state"].items():
        err = np.abs(got["state"][k] - want)
        if k.endswith((".mean", ".var")):
            assert err.max() < tol["stats"], k
            continue
        g, r = got["grads"][k], ref["grads"][k]
        loose = np.abs(g - r) > tol["resolved"] * np.minimum(np.abs(g),
                                                             np.abs(r))
        assert err[~loose].max(initial=0.0) < \
            LR * tol["resolved"] / 4 + 1e-7, k
        unresolved += int(loose.sum())
        entries += loose.size
    assert unresolved < tol["unresolved_share"] * entries


def _scene_spec():
    cfg = _scene_config("float32")
    model = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(3))
    return dict(model="scene", config=cfg, lr=LR, weight_decay=DECAY,
                inner_masked=True,
                state={k: v.numpy() for k, v in model.state_dict().items()})


def _scene_batch(b: int):
    rng = np.random.default_rng(13)
    return {"points": scene_blocks(rng, b, 1024).astype(np.float32),
            "label": rng.integers(0, 13, (b, 1024)).astype(np.int64),
            "inner_label": rng.integers(0, 2, (b, 1024)).astype(np.int32)}


def test_composed_data_by_points_step_matches_one_process(pool):
    spec, batch = _scene_spec(), _scene_batch(4)
    ranks = pool.run(W.sharded_step, spec, batch, SEED, 2)
    ref = PW.step_result(PW.build_factory(spec), batch, SEED)
    # each replica's point ranks agree bitwise; its logits are its rows
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        assert a["loss"] == b["loss"] and a["halo_ok"] and b["halo_ok"]
        np.testing.assert_array_equal(a["logits"], b["logits"])
    got = dict(ranks[0], logits=np.concatenate(
        [ranks[0]["logits"], ranks[2]["logits"]]))
    hold_step(got, ref, TOL)
