"""PyTorch port vs JAX: the ModelNet dense train step, data-parallel.

Two gloo ranks on the CPU (``parallel.run_ranks``), each with one cloud
of the global batch, run ``classification_step_factory(...,
group=...)``; JAX runs ``classification_step_factory(..., mesh=
make_mesh(jax.devices()[:2]))``'s train step on the global batch, as
one jitted program. The config is test_torch_modelnet.py's (B=2,
N=1024, windows 512/256/128, the published channels) in f32, with its
numpy-seeded weights carried across by ``utils.convert``, weight decay
0.05 (large enough that counting the replicated term R times shows) and
dropout ON: the port draws its masks from a seeded generator (each rank
its rows of the global batch's draw) and a flax interceptor applies the
same masks on the JAX side. JAX's gradients are read from its Adam
state after the step (``mu = 0.1 g``).

Tolerances (f32; the frameworks sum in other orders), as
test_torch_train.py's f32 step: loss and data loss 1e-5 relative,
logits 1e-4, each gradient leaf 2e-3 relative L2 (the one-process port
step reads up to 1.7e-4 against JAX's one-device step with these
masks), BN statistics 1e-5; after one Adam update (lr 1e-3) every
entry whose two gradients differ by less than r = 0.1 of the smaller
magnitude within lr * r / 4 + 1e-7 absolute (Adam's first step moves an
entry by lr * g / (|g| + 1e-8), about lr * sign(g): a relative gradient
difference d moves it by at most lr * d / 4, 1e-7 is f32 rounding), and
the entries not so resolved (a gradient that cancels to ~1e-7 can flip
its sign) under 1e-3 of all entries (seen: 4e-5). Both ranks end
bitwise alike. A group of one rank gives the step without a group
bitwise.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_tpu.parallel import make_mesh, shard_batch as jax_shard_batch
from sph3d_gcn_tpu.parallel.mesh import replicated
from sph3d_gcn_tpu.train.steps import (
    TrainState,
    classification_step_factory as jax_step_factory,
)
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.parallel import run_ranks
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_modelnet import _config, _flax_variables, _points
from test_torch_train import _leaves, _rel

import torch_parallel_workers as W

LR, DECAY, SEED = 1e-3, 0.05, 11
LABELS = np.array([3, 17], np.int32)
TOL = dict(loss=1e-5, logits=1e-4, grad=2e-3, stats=1e-5, resolved=0.1,
           unresolved_share=1e-3)


def _batch():
    return {"points": _points(), "label": LABELS}


def _masks(shapes):
    """The port's dropout masks on the global batch: its keep draws in
    call order from the step's generator."""
    gen = torch.Generator().manual_seed(SEED)
    return [(torch.rand(s, generator=gen) < 0.5).numpy() for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_run():
    variables = _flax_variables(_points())
    mesh = make_mesh(jax.devices()[:2])
    sf = jax_step_factory(JaxModelNet(_config("float32", jax_modelnet_config)),
                          optax.adam(LR), weight_decay=DECAY, mesh=mesh)
    state = jax.device_put(TrainState.create(variables, sf.tx),
                           replicated(mesh))
    order = ["fc1_dp", "fc2_dp"]
    widths = {"fc1_dp": 512, "fc2_dp": 256}
    keep = dict(zip(order, _masks([(len(LABELS), widths[k])
                                   for k in order])))

    def dropout(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args, **kwargs)
        x = args[0]
        assert x.shape[-1] == widths[context.module.name]
        mask = jnp.asarray(keep[context.module.name])
        return jnp.where(mask, x / 0.5, jnp.zeros_like(x))

    with fnn.intercept_methods(dropout):
        new_state, metrics, grads = jax_mesh_step(sf, state, mesh, _batch())
    return variables, new_state, metrics, grads


def jax_mesh_step(sf, state, mesh, batch):
    """One ``sf.train_step`` on the global ``batch`` sharded over
    ``mesh``: (new state, metrics, gradients), the gradients read from
    Adam's first moment (``mu = (1 - 0.9) g`` after the first step)."""
    new_state, metrics = sf.train_step(donate=False)(
        state, jax_shard_batch(mesh, batch), jax.random.key(0))
    mu = new_state.opt_state[0].mu
    grads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), mu)
    return new_state, metrics, grads


def _spec(variables):
    model = SPH3DModelNet(_config("float32"))
    state = torch_state_dict_from_flax(variables, model.state_dict())
    return dict(model="modelnet", config=_config("float32"),
                state={k: v.numpy() for k, v in state.items()}, lr=LR,
                weight_decay=DECAY)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables, new_state, metrics, grads = _jax_run()
    ranks = run_ranks(W.train_step, 2, (_spec(variables), _batch(), SEED),
                      store_dir=str(tmp_path_factory.mktemp("store")),
                      timeout=180)
    return new_state, metrics, grads, ranks


def test_ranks_stay_replicated(runs):
    _, _, _, (r0, r1) = runs
    assert r0["loss"] == r1["loss"] and r0["data_loss"] == r1["data_loss"]
    for key in ("grads", "state"):
        for k, v in r0[key].items():
            np.testing.assert_array_equal(v, r1[key][k], err_msg=k)
    assert r0["dense_ok"] and r1["dense_ok"]


def test_step_matches_jax_mesh_step(runs):
    check_against_mesh_step(*runs, TOL)


def check_against_mesh_step(new_state, metrics, grads, ranks, tol):
    """The ranks' step (``ranks``: each rank's ``step_result``) against
    JAX's mesh step: its new state, metrics and gradients."""
    r0 = ranks[0]
    assert bool(metrics["dense_ok"]) and all(r["dense_ok"] for r in ranks)
    assert _rel(r0["loss"], metrics["loss"]) < tol["loss"]
    assert _rel(r0["data_loss"], metrics["data_loss"]) < tol["loss"]
    logits = np.concatenate([r["logits"] for r in ranks])
    assert _rel(logits, metrics["logits"]) < tol["logits"]

    ours = dict(_leaves(flax_tree_from_torch(
        {k: torch.from_numpy(v) for k, v in r0["grads"].items()})["params"]))
    ref = {k: np.asarray(v) for k, v in _leaves(grads)}
    assert set(ours) == set(ref)
    errs = {k: _rel(ours[k], ref[k]) for k in ref}
    assert max(errs.values()) < tol["grad"], errs
    if "grad_median" in tol:
        assert np.median(list(errs.values())) < tol["grad_median"]

    tree = flax_tree_from_torch(
        {k: torch.from_numpy(v) for k, v in r0["state"].items()})
    stats = dict(_leaves(tree["batch_stats"]))
    ref_stats = dict(_leaves(new_state.batch_stats))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        assert _rel(stats[k], ref_stats[k]) < tol["stats"], k

    params = dict(_leaves(tree["params"]))
    unresolved_entries = entries = 0
    for k, want in _leaves(new_state.params):
        err = np.abs(params[k] - np.asarray(want))
        g, r = ours[k], ref[k]
        unresolved = (np.abs(g - r)
                      >= tol["resolved"] * np.minimum(np.abs(g), np.abs(r)))
        bound = LR * tol["resolved"] / 4 + 1e-7
        assert err[~unresolved].max(initial=0.0) < bound, k
        unresolved_entries += int(unresolved.sum())
        entries += unresolved.size
    assert unresolved_entries < tol["unresolved_share"] * entries


def test_group_of_one_is_the_plain_step(tmp_path):
    variables = _flax_variables(_points())
    (out,) = run_ranks(W.world_one, 1, (_spec(variables), _batch(), SEED),
                       store_dir=str(tmp_path), timeout=180)
    assert out == {"loss": True, "grads": True, "state": True,
                   "logits": True}
