"""PyTorch port vs JAX: the S3DIS train step.

``segmentation_step_factory(..., inner_masked=True)`` on
``s3dis_config(fast=True, dense=True)`` at its published channels, cut
to B=2, N=1024 with the widened windows of test_torch_segmentation.py
(the decoder still reaches C_in = 1024 and its inter graphs grow their
radius), against ``StepFactory._losses`` of the JAX package under
``jax.value_and_grad``. Weights are the numpy-seeded Flax tree of that
test, carried across by ``utils.convert``; labels and inner labels are
numpy-seeded. The JAX side runs its Pallas kernels in interpret mode on
the CPU; each JAX step is compiled once per module.

Tolerances (gradient leaves by their relative L2 error):

- f32: loss and logits 1e-5 / 1e-4; each gradient leaf 1e-2. The largest
  errors (seen: 4.2e-3) sit on batch-norm biases of the decoder, whose
  gradient, a sum of the upstream gradient over every point of the
  batch, cancels to a small fraction of its terms, so sum-order
  differences through 20 layers and their backward stand out there; the
  median leaf is held to 1e-4. New BN statistics within 1e-5.
- bf16: as tests/test_torch_train.py, each leaf of the port's bf16
  gradient is held to JAX's f32 gradient, within 1.5x JAX's own bf16
  step's error on that leaf plus 0.02 (the two frameworks round at other
  points; a cancelling BN bias differs from its f32 value by more than
  100% in JAX itself). Loss 2e-2, logits 5e-2, statistics 2e-3.
- One Adam update (f32, lr 1e-3) against optax on the JAX gradients:
  every parameter within 1e-5 absolute, except entries whose two
  gradients are both below 1e-6 in magnitude (Adam's first step moves an
  entry by about lr * sign(g), so a sign flip of a vanishing gradient
  moves it by up to 2e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_tpu.models import SPH3DSceneSeg as JaxSceneSeg
from sph3d_gcn_tpu.train.steps import (
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.configs import s3dis_config
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import segmentation_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_segmentation import _config, _flax_variables, _points
from test_torch_train import _leaves, _rel

B, N = 2, 1024
LR = 1e-3
STEP_TOL = {"float32": dict(loss=1e-5, logits=1e-4, grad=1e-2,
                            grad_median=1e-4, stats=1e-5),
            "bfloat16": dict(loss=2e-2, logits=5e-2, stats=2e-3)}


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(7)
    return (_points(),
            rng.integers(0, 13, (B, N)).astype(np.int32),
            rng.integers(0, 2, (B, N)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _variables():
    return _flax_variables(_points())


@functools.lru_cache(maxsize=None)
def _jax_step(dtype):
    """JAX's (loss, data loss, logits, new stats, ok, grads) of one
    inner-masked segmentation train step."""
    pts, labels, inner = _batch()
    variables = _variables()
    sf = jax_seg_step_factory(JaxSceneSeg(_config(dtype, jax_s3dis_config)),
                              optax.adam(LR), inner_masked=True)
    batch = {"points": jnp.asarray(pts), "label": jnp.asarray(labels),
             "inner_label": jnp.asarray(inner)}

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    (total, (data_loss, logits, new_stats, ok, _)), grads = jax.jit(
        jax.value_and_grad(losses, has_aux=True)
    )(variables["params"], variables["batch_stats"])
    return total, data_loss, logits, new_stats, ok, grads


def _torch_step(dtype):
    """The port's step on the same variables and batch, before its
    update: (step factory, metrics)."""
    pts, labels, inner = _batch()
    model = SPH3DSceneSeg(_config(dtype))
    model.load_state_dict(
        torch_state_dict_from_flax(_variables(), model.state_dict()))
    opt, sch = make_optimizer(model.parameters(), "adam", LR)
    step = segmentation_step_factory(model, opt, sch, inner_masked=True)
    metrics = step.loss_and_grads({"points": torch.from_numpy(pts),
                                   "label": torch.from_numpy(labels),
                                   "inner_label": torch.from_numpy(inner)})
    return step, metrics


def _grads(model):
    return dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_train_step_matches_jax(dtype):
    tol = STEP_TOL[dtype]
    total, data_loss, logits, new_stats, ok, grads = _jax_step(dtype)
    ref = dict(_leaves(grads))
    with _build.record_calls() as calls:
        step, metrics = _torch_step(dtype)
    names = [name for name, _, _ in calls]
    # every backward of the path: 16 convs, 4 pools, 4 unpools
    assert (names.count("dense_conv_bwd"), names.count("rank_pool_bwd"),
            names.count("mean_interpolate_bwd")) == (16, 4, 4)
    widths = sorted({args[2].shape[-1] for name, args, _ in calls
                     if name == "dense_conv_bwd"})
    assert widths == [64, 128, 256, 512, 1024]

    assert bool(metrics["dense_ok"]) and bool(ok)
    assert _rel(metrics["loss"], total) < tol["loss"]
    assert _rel(metrics["data_loss"], data_loss) < tol["loss"]
    assert _rel(metrics["logits"], logits) < tol["logits"]
    ours = _grads(step.model)
    assert set(ours) == set(ref)
    if dtype == "float32":
        errs = {k: _rel(ours[k], ref[k]) for k in ref}
        bound = {k: tol["grad"] for k in ref}
        assert np.median(list(errs.values())) < tol["grad_median"]
    else:
        f32 = dict(_leaves(_jax_step("float32")[-1]))
        bound = {k: 1.5 * _rel(ref[k], f32[k]) + 0.02 for k in ref}
        errs = {k: _rel(ours[k], f32[k]) for k in ref}
    bad = {k: (errs[k], bound[k]) for k in ref if not errs[k] < bound[k]}
    assert not bad, bad
    stats = dict(_leaves(flax_tree_from_torch(
        {k: v for k, v in step.model.state_dict().items()
         if k.endswith((".mean", ".var"))})["batch_stats"]))
    ref_stats = dict(_leaves(new_stats))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])


def test_seg_adam_update_matches_optax():
    """One Adam update of the port's f32 step against optax's on the JAX
    gradients of the same step."""
    grads = _jax_step("float32")[-1]
    params = _variables()["params"]
    tx = optax.adam(LR)
    ref = dict(_leaves(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)))
    g_ref = dict(_leaves(grads))
    before = dict(_leaves(params))
    step, _ = _torch_step("float32")
    g_ours = _grads(step.model)
    step.optimizer.step()
    step.scheduler.step()
    ours = dict(_leaves(flax_tree_from_torch(
        dict(step.model.named_parameters()))["params"]))
    assert set(ours) == set(ref)
    moved = 0
    for k in ref:
        r = np.asarray(ref[k], np.float32)
        vanishing = (np.abs(g_ours[k]) < 1e-6) & (np.abs(g_ref[k]) < 1e-6)
        err = np.where(vanishing, 0.0, np.abs(ours[k] - r))
        assert err.max() <= 1e-5, (k, err.max())
        moved += int((ours[k] != np.asarray(before[k])).sum())
    assert moved > 0.9 * sum(np.size(v) for v in ref.values())


def test_seg_step_failed_certificate_reports_and_fallback_raises():
    """Windows too small for the blocks: the step reports the failed
    certificate as a False ``dense_ok`` tensor and applies its update, as
    the ModelNet step does (no host read of the certificate, no restore of
    the running statistics); the recovery path (``classic_fallback()``,
    on the scene model's per-edge engine) runs the batch on the same
    parameters, raising nothing."""
    cfg = dataclasses.replace(_config("float32"), dec_margin=0,
                              growth_steps=1, windows=(128,) * 4)
    model = SPH3DSceneSeg(cfg, generator=torch.Generator().manual_seed(0))
    step = segmentation_step_factory(model, *make_optimizer(
        model.parameters()), inner_masked=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pts, labels, _ = _batch()
    batch = {"points": torch.from_numpy(pts),
             "label": torch.from_numpy(labels)}
    metrics = step.train_step(batch)
    assert isinstance(metrics["dense_ok"], torch.Tensor)
    assert not bool(metrics["dense_ok"]) and not bool(model.dense_ok)
    after = model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items()
               if k.endswith((".mean", ".var")))
    assert all(p.grad is not None for p in model.parameters())
    assert step.optimizer.state
    assert step.scheduler.last_epoch == 1
    fb = step.classic_fallback()
    assert fb.model is not model and not fb.model.config.dense_graph
    assert fb.optimizer is step.optimizer
    metrics = fb.train_step(batch)
    assert bool(metrics["dense_ok"]) and torch.isfinite(metrics["loss"])
    assert step.scheduler.last_epoch == 2
