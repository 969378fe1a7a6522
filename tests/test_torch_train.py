"""PyTorch port vs JAX: the ModelNet dense-mode train step and its parts.

- BatchNorm in train mode against flax ``BatchNorm``: output, gradients
  and the updated running statistics.
- The staircase schedule and the optimizers against optax.
- One whole train step (forward in train mode, loss with weight decay,
  backward, BN statistics) against ``StepFactory._losses`` under
  ``jax.value_and_grad``, on the config of test_torch_modelnet.py (B=2,
  N=1024, windows 512/256/128, the published channels), with the weights
  carried across by ``utils.convert``. Dropout is the identity on both
  sides: a ``flax.linen.intercept_methods`` interceptor on the JAX side,
  rate 0 on the port's.
- Port-only checks: dropout, the certificate in the step's metrics, the
  reverse converter.

Tolerances are stated per test; gradient leaves are compared by their
relative L2 error ``|got - ref| / |ref|``.
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

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_tpu.nn.layers import l2_regularization as jax_l2
from sph3d_gcn_tpu.train.schedule import (
    exponential_decay_lr as jax_decay_lr,
)
from sph3d_gcn_tpu.train.steps import (
    classification_step_factory as jax_step_factory,
)
from sph3d_gcn_torch.configs import modelnet_config
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.nn.layers import BatchNorm, Dropout, l2_regularization
from sph3d_gcn_torch.train.schedule import exponential_decay_lr, make_optimizer
from sph3d_gcn_torch.train.steps import classification_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_modelnet import (  # the serving-forward test's config
    _config,
    _flax_variables,
    _points,
    variables,  # noqa: F401  (module-scoped fixture)
)

LABELS = np.array([3, 17], np.int32)


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every ``nn.Dropout`` call returns its input."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


# ------------------------------------------------------------ BatchNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Output (f32 rtol=atol=1e-5; bf16 one rounding: 1e-2), gradients in
    the input and the affine terms (f32 1e-5 relative; bf16 2e-2: the
    cotangent reaches the input through bf16 and the f32 statistics are
    reduced in other orders) and the updated running statistics (1e-6)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 50, 16)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    mean = rng.standard_normal(16).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    cot = rng.standard_normal((4, 50, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3, dtype=jdt, param_dtype=jnp.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def jf(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)

    (_, (ref_y, upd)), (gp, gx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x, jdt))

    m = BatchNorm(16).train()
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.mean.copy_(torch.from_numpy(mean))
        m.var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = m(xt)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == tdt
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(y.float().detach().numpy(),
                               np.asarray(ref_y, np.float32), rtol=tol,
                               atol=tol)
    gtol = 2e-2 if dtype == "bfloat16" else 1e-5
    assert _rel(xt.grad.float(), gx.astype(jnp.float32)) < gtol
    assert _rel(m.scale.grad, gp["scale"]) < gtol
    assert _rel(m.bias.grad, gp["bias"]) < gtol
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(m, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------- schedule and optimizer


def test_exponential_decay_matches_optax():
    """The staircase and its 1e-6 floor, step by step (f32 rtol 1e-6)."""
    ours = exponential_decay_lr(0.001, batch_size=4, decay_step=40,
                                decay_rate=0.5)
    ref = jax_decay_lr(0.001, batch_size=4, decay_step=40, decay_rate=0.5)
    for count in (0, 1, 9, 10, 11, 29, 30, 95, 100, 1000):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)
    assert ours(1000) == 1e-6


@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_optimizer_matches_optax(name):
    """Six updates of a small parameter tree under the staircase schedule
    (Adam eps 1e-8 / Nesterov momentum 0.9) against optax: parameters
    within rtol=1e-5, atol=1e-7 (f32 arithmetic in other orders)."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    sched_t = exponential_decay_lr(0.01, batch_size=1, decay_step=2,
                                   decay_rate=0.7)
    sched_j = jax_decay_lr(0.01, batch_size=1, decay_step=2, decay_rate=0.7)
    tx = (optax.adam(sched_j, eps=1e-8) if name == "adam"
          else optax.sgd(sched_j, momentum=0.9, nesterov=True))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt, sch = make_optimizer(list(tp.values()), name, sched_t)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sch.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        make_optimizer(list(tp.values()), "rmsprop")


# ------------------------------------------------------- the whole step

# Tolerances of the whole step. f32: relative L2 error of the loss, the
# logits and every gradient leaf (sums in other orders through 12 layers
# and their backward; the largest leaf error seen was ~1e-4), absolute
# error of the new running statistics. bf16: the two frameworks round at
# different points (the JAX conv backward rounds its stashed bin sums, dS
# and per-tile window gradients to bf16), and at B=2 every batch-norm
# backward cancels most of its input, so a bf16 gradient leaf differs
# from the f32 one by 10-90% in JAX itself. The port's bf16 gradients are
# held to the f32 reference instead: each leaf's error may be at most
# 1.5x the JAX bf16 step's own error on that leaf, plus 0.02 (seen: at
# most 1.3x).
STEP_TOL = {"float32": dict(loss=1e-5, logits=1e-4, grad=2e-3, stats=1e-5),
            "bfloat16": dict(loss=2e-2, logits=5e-2, stats=2e-3)}


@functools.lru_cache(maxsize=None)
def _jax_step(dtype):
    """JAX's (loss, data loss, logits, new stats, ok, grads) of one train
    step with dropout intercepted, on the numpy-seeded variables."""
    pts = _points()
    variables = _flax_variables(pts)
    jcfg = _config(dtype, jax_modelnet_config)
    sf = jax_step_factory(JaxModelNet(jcfg), optax.adam(1e-3),
                          weight_decay=jcfg.weight_decay)
    batch = {"points": jnp.asarray(pts), "label": jnp.asarray(LABELS)}

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    with fnn.intercept_methods(_no_dropout):
        (total, (data_loss, logits, new_stats, ok, _)), grads = jax.jit(
            jax.value_and_grad(losses, has_aux=True)
        )(variables["params"], variables["batch_stats"])
    return total, data_loss, logits, new_stats, ok, dict(_leaves(grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(variables, dtype):
    tol = STEP_TOL[dtype]
    pts = _points()
    total, data_loss, logits, new_stats, ok, ref = _jax_step(dtype)

    cfg = _config(dtype)
    model = SPH3DModelNet(cfg)
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict()))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    opt, sch = make_optimizer(model.parameters(), "adam", 1e-3)
    step = classification_step_factory(model, opt, sch,
                                       weight_decay=cfg.weight_decay)
    metrics = step.loss_and_grads({"points": torch.from_numpy(pts),
                                   "label": torch.from_numpy(LABELS)})

    assert bool(metrics["dense_ok"]) and bool(ok)
    assert _rel(metrics["loss"], total) < tol["loss"]
    assert _rel(metrics["data_loss"], data_loss) < tol["loss"]
    assert _rel(metrics["logits"], logits) < tol["logits"]
    ours = dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    assert set(ours) == set(ref)
    if dtype == "float32":
        bound = {k: tol["grad"] for k in ref}
        errs = {k: _rel(ours[k], ref[k]) for k in ref}
    else:
        f32 = _jax_step("float32")[-1]
        bound = {k: 1.5 * _rel(ref[k], f32[k]) + 0.02 for k in ref}
        errs = {k: _rel(ours[k], f32[k]) for k in ref}
    bad = {k: (errs[k], bound[k]) for k in ref if not errs[k] < bound[k]}
    assert not bad, bad
    stats = dict(_leaves(flax_tree_from_torch(
        {k: v for k, v in model.state_dict().items()
         if k.endswith((".mean", ".var"))})["batch_stats"]))
    ref_stats = dict(_leaves(new_stats))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])


def test_l2_regularization_matches_jax(variables):
    """Weights, depthwise filters and BN scale/bias; not ``biases``
    (f32 rtol 1e-6)."""
    model = SPH3DModelNet(_config("float32"))
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict()))
    np.testing.assert_allclose(
        float(l2_regularization(model).detach()),
        float(jax_l2(variables["params"])), rtol=1e-6)


# ------------------------------------------------------------ port only


def test_dropout_seeded_scaled_and_eval_identity():
    x = torch.randn(64, 256)
    d = Dropout(0.5).train()
    a = d(x, torch.Generator().manual_seed(7))
    b = d(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.4 < kept.float().mean() < 0.6
    assert torch.equal(a[kept], 2 * x[kept])
    assert not torch.equal(a, d(x, torch.Generator().manual_seed(8)))
    assert d.eval()(x) is x
    xb = x.bfloat16()
    ab = Dropout(0.5).train()(xb, torch.Generator().manual_seed(7))
    assert ab.dtype == torch.bfloat16
    assert torch.equal(ab[ab != 0], 2 * xb[ab != 0])


def test_train_step_reports_failed_certificate():
    """A window too small for the cloud: the step still runs and its
    metrics carry ``dense_ok`` False as a tensor."""
    cfg = dataclasses.replace(modelnet_config(num_input=512, fast=True,
                                              dense=True), windows=(128,))
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    opt, sch = make_optimizer(model.parameters())
    step = classification_step_factory(model, opt, sch, weight_decay=1e-5)
    pts = np.random.default_rng(1).standard_normal((2, 512, 3))
    metrics = step.train_step(
        {"points": torch.from_numpy(pts.astype(np.float32)),
         "label": torch.tensor([1, 2])},
        torch.Generator().manual_seed(0))
    assert isinstance(metrics["dense_ok"], torch.Tensor)
    assert not bool(metrics["dense_ok"])
    assert torch.isfinite(metrics["loss"])
    assert sch.last_epoch == 1


def test_reverse_converter_round_trips(variables):
    model = SPH3DModelNet(_config("float32"))
    sd = torch_state_dict_from_flax(variables, model.state_dict())
    tree = flax_tree_from_torch(sd)
    assert set(tree) == {"params", "batch_stats"}
    assert "BatchNorm_0" in tree["params"]["conv1"]["_1"]["bn"]
    back = torch_state_dict_from_flax(tree, model.state_dict())
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])


def test_classic_fallback_shares_parameters():
    """``StepFactory.classic_fallback()``: the same parameters, buffers,
    optimizer and scheduler under a model on the per-edge engine. A step
    through it on a batch whose dense certificate fails changes the dense
    model's weights and statistics exactly as a step of a separate
    per-edge model from the same state does (f32, same batch, no
    dropout)."""
    cfg = dataclasses.replace(
        modelnet_config(num_input=512, fast=True, dense=True),
        windows=(128,), compute_dtype="float32")
    model = SPH3DModelNet(cfg, generator=torch.Generator().manual_seed(0))
    other = SPH3DModelNet(dataclasses.replace(cfg, dense_graph=False))
    other.load_state_dict(model.state_dict())
    for m in (*model.modules(), *other.modules()):
        if isinstance(m, Dropout):
            m.rate = 0.0
    pts = np.random.default_rng(1).standard_normal((2, 512, 3))
    batch = {"points": torch.from_numpy(pts.astype(np.float32)),
             "label": torch.tensor([1, 2])}
    step = classification_step_factory(
        model, *make_optimizer(model.parameters()), weight_decay=1e-5)
    assert not bool(step.eval_step(batch)["dense_ok"])
    fb = step.classic_fallback()
    assert fb.optimizer is step.optimizer and fb.scheduler is step.scheduler
    assert fb.model is not model and not fb.model.config.dense_graph
    assert fb.model.conv1._1.weights is model.conv1._1.weights
    assert fb.classic_fallback() is fb
    ref = classification_step_factory(
        other, *make_optimizer(other.parameters()), weight_decay=1e-5)
    m_fb, m_ref = fb.train_step(batch), ref.train_step(batch)
    assert bool(m_fb["dense_ok"]) and torch.equal(m_fb["loss"], m_ref["loss"])
    got, want = model.state_dict(), other.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert step.scheduler.last_epoch == 1
