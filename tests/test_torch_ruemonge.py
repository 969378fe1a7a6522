"""PyTorch port vs JAX: the RueMonge2014 facade model.

``ruemonge2014_config`` against JAX's, ``normalize_mean_center``, and
``SPH3DRueMonge`` on ``ruemonge2014_config(fast=True, dense=True)`` at its
published channels, cut to B=2, N=512 (levels 512 -> 128 -> 48 -> 24 ->
8, the config's own scaling) with windows measured on these blocks
(``utils.windows``, 10% margin), on 9-column points (xyz of scene
blocks, unit normals, rgb): its input features are the mean-centered xyz
and the columns 3: (9 channels into ``mlp1``, where the S3DIS model's
rule would give 6). Numpy-seeded weights in the Flax layout, carried
across by ``utils.convert``. The f32 logits within rtol=atol=1e-4, and
one f32 train step with the plain mean loss (no inner mask) against
JAX's with tests/test_torch_seg_train.py's f32 tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph3d_gcn_tpu.configs import ruemonge2014_config as jax_ruemonge_config
from sph3d_gcn_tpu.models import SPH3DRueMonge as JaxRueMonge
from sph3d_gcn_tpu.models.common import (
    normalize_mean_center as jax_normalize_mean_center,
)
from sph3d_gcn_tpu.train.steps import (
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.configs import ruemonge2014_config
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DRueMonge
from sph3d_gcn_torch.models.common import normalize_mean_center
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import segmentation_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_configs_data import assert_same_config
from test_torch_seg_train import STEP_TOL
from test_torch_shapenet import seeded_variables
from test_torch_train import _leaves, _rel

B, N = 2, 512
LR = 1e-3


def _config(dtype, factory=ruemonge2014_config):
    return dataclasses.replace(
        factory(num_input=N, fast=True, dense=True),
        windows=(384, 128, 128, 128), growth_steps=12, compute_dtype=dtype)


@pytest.mark.parametrize("kw", [
    {},
    {"fast": True},
    {"fast": True, "dense": True},
    {"num_input": 1024, "fast": True, "dense": True},
])
def test_ruemonge_config_matches_jax(kw):
    cfg = ruemonge2014_config(**kw)
    assert_same_config(cfg, jax_ruemonge_config(**kw))
    assert cfg.num_cls == 7


def test_normalize_mean_center_matches_jax():
    x = np.random.default_rng(20).uniform(0, 3, (3, 100, 3)).astype(
        np.float32)
    got = normalize_mean_center(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_normalize_mean_center(
        jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.mean(axis=1), 0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _batch():
    """(B, N, 9) points: xyz of scene blocks, unit normals, rgb; labels."""
    rng = np.random.default_rng(21)
    xyz = scene_blocks(rng, B, N)[..., :3]
    normals = rng.standard_normal((B, N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    rgb = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    pts = np.concatenate([xyz, normals, rgb], -1).astype(np.float32)
    return pts, rng.integers(0, 7, (B, N)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _variables():
    shapes = jax.eval_shape(
        lambda p: JaxRueMonge(_config("float32", jax_ruemonge_config)).init(
            jax.random.key(0), p), _batch()[0])
    return seeded_variables(shapes, np.random.default_rng(22))


def _port_model():
    model = SPH3DRueMonge(_config("float32"))
    model.load_state_dict(
        torch_state_dict_from_flax(_variables(), model.state_dict()))
    return model


def test_ruemonge_logits_match_jax():
    pts, _ = _batch()
    ref, inter = jax.jit(lambda v, p: JaxRueMonge(
        _config("float32", jax_ruemonge_config)).apply(
            v, p, mutable=["intermediates"]))(_variables(), pts)
    (ref_ok,) = jax.tree_util.tree_leaves(inter["intermediates"])
    model = _port_model().eval()
    assert model.backbone.mlp1.weights.shape == (9, 64)
    with _build.record_calls() as calls, torch.no_grad():
        got = model(torch.from_numpy(pts))
    assert got.shape == (B, N, 7) and got.dtype == torch.float32
    assert bool(model.dense_ok) and bool(ref_ok)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
    assert len([n for n, _, _ in calls if n == "dense_conv"]) == 16
    # the features read the normals and rgb: changing them moves logits
    moved = pts.copy()
    moved[..., 3:] *= -1
    with torch.no_grad():
        other = model(torch.from_numpy(moved))
    assert (other - got).abs().max() > 1e-3


def test_ruemonge_train_step_matches_jax():
    tol = STEP_TOL["float32"]
    pts, labels = _batch()
    sf = jax_seg_step_factory(
        JaxRueMonge(_config("float32", jax_ruemonge_config)),
        optax.adam(LR))
    variables = _variables()
    jbatch = {"points": jnp.asarray(pts), "label": jnp.asarray(labels)}

    def losses(params, stats):
        return sf._losses(params, stats, jbatch, jax.random.key(0), True)

    (total, (data_loss, logits, new_stats, ok, _)), grads = jax.jit(
        jax.value_and_grad(losses, has_aux=True)
    )(variables["params"], variables["batch_stats"])

    model = _port_model()
    step = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", LR))
    metrics = step.loss_and_grads({"points": torch.from_numpy(pts),
                                   "label": torch.from_numpy(labels)})
    assert bool(metrics["dense_ok"]) and bool(ok)
    assert _rel(metrics["loss"], total) < tol["loss"]
    assert _rel(metrics["data_loss"], data_loss) < tol["loss"]
    assert _rel(metrics["logits"], logits) < tol["logits"]
    ours = dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    ref = dict(_leaves(grads))
    assert set(ours) == set(ref)
    errs = {k: _rel(ours[k], ref[k]) for k in ref}
    bad = {k: e for k, e in errs.items() if not e < tol["grad"]}
    assert not bad, bad
    assert np.median(list(errs.values())) < tol["grad_median"]
    stats = dict(_leaves(flax_tree_from_torch(
        {k: v for k, v in model.state_dict().items()
         if k.endswith((".mean", ".var"))})["batch_stats"]))
    ref_stats = dict(_leaves(new_stats))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])
