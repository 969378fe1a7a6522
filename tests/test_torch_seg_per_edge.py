"""PyTorch port vs JAX: the scene models' per-edge engine.

The per-edge unpools (``ops.unpool``), the decoder's edge-list graphs
(``nn.graph.build_graph_deconv``), ``SPH3DSceneSeg`` on
``s3dis_config(fast=True)`` with ``dense_graph=False`` (forward and train
step), and the recovery of a dense scene batch whose certificate fails
(``StepFactory.classic_fallback()``, ``train.eval.checked_eval_step``).
The model runs at its published channels, cut to B=2, N=1024 as in
test_torch_segmentation.py, on that file's numpy-seeded Flax weights
carried across by ``utils.convert``. JAX runs its Pallas one-hot gather
in interpret mode on the CPU; the port runs the plain twins of K8 and K9
(the kernels are held against these on the card at the unpool's shapes,
tests/test_torch_dispatch.py). Each JAX side is built once per module.

Tolerances:

- unpool values: f32 rtol=atol=1e-6 (sums over K in another order), bf16
  rtol=atol=1e-2 (one bf16 rounding of the sum; the weighted product
  rounds in bf16 on both sides); gradients by relative L2 error: f32
  1e-6; bf16 held to JAX's f32 gradient, no worse than JAX's own bf16
  gradient or one bf16 rounding (2^-8), as test_torch_windowed.py holds
  the gather's;
- graph: idx, count and bins exact on a grid cloud whose squared
  distances are exact in f32; dist within 1 ulp (the x86 CPU build's
  ``torch.sqrt`` may be an ulp off);
- f32 logits within 2e-3 of the largest |logit|, equal argmax (f32 sums
  in other orders through 20 layers and a growing query);
- the train step: test_torch_seg_train.py's f32 tolerances, its one
  Adam update against optax's on the JAX gradients included;
- the fallback: bitwise equal to a direct per-edge step (one device, the
  same operations in the same order).
"""

import copy
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
from sph3d_gcn_tpu.nn.graph import build_graph_deconv as j_deconv_graph
from sph3d_gcn_tpu.ops.unpool import mean_interpolate as j_mean
from sph3d_gcn_tpu.ops.unpool import weighted_interpolate as j_weighted
from sph3d_gcn_tpu.train.steps import (
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.nn.graph import build_graph_deconv
from sph3d_gcn_torch.ops.types import Neighborhood
from sph3d_gcn_torch.ops.unpool import mean_interpolate, weighted_interpolate
from sph3d_gcn_torch.train.eval import checked_eval_step
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import segmentation_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_seg_train import STEP_TOL, _batch
from test_torch_segmentation import _config, _flax_variables, _points
from test_torch_train import _leaves, _rel
from test_torch_windowed import _f32, local_edges

B, N = 2, 1024
LR = 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


# --------------------------------------------------------------- the ops

def _unpool_inputs(seed=0):
    """Coarse features (B, 96, 7), a fine cloud of M = 4N = 384 queries
    with K = 9 lanes into it (counts 0..K), f32 weights with inf on the
    invalid lanes, and a (B, M_pad, C) cotangent."""
    rng = np.random.default_rng(seed)
    b, n, m, k, c = 2, 96, 384, 9, 7
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    idx, count = local_edges(rng, b, n, m, k, 12)
    count[0, :5] = 0
    count[1, :5] = k
    weight = rng.uniform(0.1, 1.0, (b, m, k)).astype(np.float32)
    weight[np.arange(k) >= count[..., None]] = np.inf
    cot = rng.standard_normal((b, m, c)).astype(np.float32)
    return feats, idx, count, weight, cot


def _jax_unpool(method, window, jdt, feats, idx, count, weight):
    args = (jnp.asarray(idx), jnp.asarray(count))

    def fn(x):
        if method == "mean":
            return j_mean(x, *args, window=window)
        return j_weighted(x, jnp.asarray(weight), *args, window=window)

    return jax.vjp(fn, jnp.asarray(feats, jdt))


def _port_unpool(method, window, tdt, feats, idx, count, weight):
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    args = (torch.from_numpy(idx).long(), torch.from_numpy(count).long())
    if method == "mean":
        out = mean_interpolate(x, *args, window=window)
    else:
        out = weighted_interpolate(x, torch.from_numpy(weight), *args,
                                   window=window)
    return x, out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [128, None])
@pytest.mark.parametrize("method", ["mean", "weighted"])
def test_unpool_matches_jax(method, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feats, idx, count, weight, cot = _unpool_inputs()
    ref, vjp = _jax_unpool(method, window, jdt, feats, idx, count, weight)
    x, got = _port_unpool(method, window, tdt, feats, idx, count, weight)
    assert got.shape == ref.shape == (2, 384, 7)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert np.isfinite(_f32(got)).all()
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=tol, atol=tol)
    # rows with no neighbor give 0
    assert (_f32(got)[0, :5] == 0).all()

    got.backward(torch.from_numpy(cot).to(got.dtype))
    assert x.grad.dtype == tdt
    ref32 = _f32(_jax_unpool(method, window, jnp.float32, feats, idx, count,
                             weight)[1](jnp.asarray(cot))[0])
    assert np.abs(ref32).max() > 0
    if dtype == "float32":
        assert _rel(_f32(x.grad), ref32) < 1e-6
    else:
        jax_err = _rel(_f32(vjp(jnp.asarray(cot, ref.dtype))[0]), ref32)
        assert _rel(_f32(x.grad), ref32) <= max(jax_err, 2.0 ** -8)


# -------------------------------------------------------------- the graph

def test_deconv_graph_matches_jax():
    """A fine cloud of 1024 scene points searching every fourth point, 64
    of them lifted 45/128 m above the block's top (no coarse point within
    the radius: they grow it), and rows crowded past K. The points lie on
    a 2^-7 grid, so each squared distance of the query's matmul form
    (``|q|^2 - 2 q.p + |p|^2``) is exact in f32 in any order of its
    terms: CPU matmuls may associate the three products differently from
    run to run, and at scene coordinates (up to 3 m) the form's rounding
    (~1e-6) would decide a point within ~1e-5 of the radius, on both
    sides, whichever engine computes it (the JAX op's form, not the
    port's choice)."""
    pts = scene_blocks(np.random.default_rng(8), 2, 1024)[..., :3]
    pts = np.round(pts * 128) / 128
    fine = pts.copy()
    fine[:, -64:, 2] = pts[..., 2].max() + 45 / 128
    coarse = np.ascontiguousarray(pts[:, ::4])
    ref_intra, ref_filt, ref_inter = j_deconv_graph(
        jnp.asarray(coarse), jnp.asarray(fine), 0.3, 8, kernel=(8, 2, 2))
    intra, filt, inter = build_graph_deconv(
        torch.from_numpy(coarse), torch.from_numpy(fine), 0.3, 8,
        kernel=(8, 2, 2))
    for got, ref in ((intra, ref_intra), (inter, ref_inter)):
        assert isinstance(got, Neighborhood)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(ref.count))
        np.testing.assert_array_max_ulp(got.dist.numpy(),
                                        np.asarray(ref.dist), maxulp=1)
    np.testing.assert_array_equal(filt.numpy(), np.asarray(ref_filt))
    # the lifted rows grew their radius and found coarse neighbors
    d = np.linalg.norm(fine[:, -64:, None] - coarse[:, None], axis=-1)
    assert (d.min(-1) >= 0.3).all()
    assert (inter.count[:, -64:] >= 1).all()
    assert int(intra.count.max()) == int(inter.count.max()) == 8


# -------------------------------------------------------------- the model

def _edge_config(dtype="float32", factory=None, **kw):
    """The per-edge engine of the test's S3DIS config."""
    cfg = (_config(dtype) if factory is None
           else _config(dtype, factory))
    return dataclasses.replace(cfg, dense_graph=False, **kw)


def _jax_edge_config(**kw):
    """The JAX side of :func:`_edge_config`: the same config without its
    row windows, so that JAX takes its plain gather. The function is the
    same: the JAX one-hot gather is exact (a tile its window misses takes
    the plain gather), and the port's K8 reads rows by index with the
    window unused; without windows JAX traces no interpret-mode kernel,
    which halves its compile time on the CPU."""
    return _edge_config(factory=jax_s3dis_config, windows=None,
                        dec_windows=None, **kw)


@pytest.fixture(scope="module")
def variables():
    return _flax_variables(_points())


def _port_model(variables, **kw):
    model = SPH3DSceneSeg(_edge_config(**kw))
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict()))
    return model


@pytest.mark.parametrize("unpool", ["mean", "weighted"])
def test_per_edge_scene_logits_match_jax(variables, unpool):
    jcfg = _jax_edge_config(unpool_method=unpool)
    pts = _points()
    ref = np.asarray(jax.jit(lambda v, p: JaxSceneSeg(jcfg).apply(v, p))(
        variables, pts))
    model = _port_model(variables, unpool_method=unpool).eval()
    with _build.record_calls() as calls, torch.no_grad():
        got = model(torch.from_numpy(pts))
    names = [name for name, _, _ in calls]
    # FPS at every level; 8 encoder convs, 4 pools, 8 decoder convs and 4
    # unpools through the edge gather
    assert (names.count("fps"), names.count("window_gather"),
            len(names)) == (4, 24, 28)
    # each decoder level's third gather, the unpool, gathers fine rows
    # from the coarse cloud (M = 2-4 N)
    shapes = [(args[0].shape[1], args[1].shape[1]) for name, args, _ in calls
              if name == "window_gather"]
    assert [m / n for n, m in shapes[-12:][2::3]] == [3, 2, 256 / 96, 4]
    assert not model.config.dense_graph and bool(model.dense_ok)
    assert got.dtype == torch.float32 and got.shape == (B, N, 13)
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-3 * scale)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's (loss, data loss, logits, new stats, grads) of one
    inner-masked per-edge step with the weighted unpool."""
    pts, labels, inner = _batch()
    variables = _flax_variables(pts)
    cfg = _jax_edge_config(unpool_method="weighted")
    sf = jax_seg_step_factory(JaxSceneSeg(cfg), optax.adam(LR),
                              inner_masked=True)
    batch = {"points": jnp.asarray(pts), "label": jnp.asarray(labels),
             "inner_label": jnp.asarray(inner)}

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    (total, (data_loss, logits, new_stats, _, _)), grads = jax.jit(
        jax.value_and_grad(losses, has_aux=True)
    )(variables["params"], variables["batch_stats"])
    return total, data_loss, logits, new_stats, grads


def test_per_edge_scene_train_step_matches_jax(variables):
    tol = STEP_TOL["float32"]
    total, data_loss, logits, new_stats, grads = _jax_step()
    ref = dict(_leaves(grads))
    pts, labels, inner = _batch()
    model = _port_model(variables, unpool_method="weighted")
    step = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", LR),
        inner_masked=True)
    with _build.record_calls() as calls:
        metrics = step.loss_and_grads({"points": torch.from_numpy(pts),
                                       "label": torch.from_numpy(labels),
                                       "inner_label": torch.from_numpy(inner)})
    names = [name for name, _, _ in calls]
    assert (names.count("window_gather"),
            names.count("window_gather_bwd")) == (24, 24)
    assert bool(metrics["dense_ok"])
    assert _rel(metrics["loss"], total) < tol["loss"]
    assert _rel(metrics["data_loss"], data_loss) < tol["loss"]
    assert _rel(metrics["logits"], logits) < tol["logits"]
    ours = dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
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
    # the updated leaves: the port's Adam step against optax's on the JAX
    # gradients, as test_torch_seg_train.py holds them (an entry whose two
    # gradients both vanish may move by up to 2 lr on a sign flip)
    step.optimizer.step()
    params = variables["params"]
    tx = optax.adam(LR)
    new = dict(_leaves(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(
            grads, params)))
    updated = dict(_leaves(flax_tree_from_torch(
        dict(model.named_parameters()))["params"]))
    for k in new:
        vanishing = (np.abs(ours[k]) < 1e-6) & (np.abs(ref[k]) < 1e-6)
        err = np.where(vanishing, 0.0,
                       np.abs(updated[k] - np.asarray(new[k], np.float32)))
        assert err.max() <= 1e-5, (k, err.max())


# ----------------------------------------------------------- the fallback

def _tight_config():
    """Windows too small for the blocks: the dense certificate fails."""
    return dataclasses.replace(_config("float32"), dec_margin=0,
                               growth_steps=1, windows=(128,) * 4)


def _torch_batch():
    """The first item of the train step's batch (one cloud keeps the
    per-edge steps on the CPU short)."""
    pts, labels, inner = _batch()
    return {"points": torch.from_numpy(pts[:1]),
            "label": torch.from_numpy(labels[:1]),
            "inner_label": torch.from_numpy(inner[:1])}


def test_failed_dense_step_recovers_through_classic_fallback():
    """A dense step on a batch its windows do not cover returns dense_ok
    False on the device; restored to its pre-step state and re-run
    through ``classic_fallback()``, the dense model ends bitwise where a
    direct per-edge step from the same state ends, and the optimizer and
    scheduler stepped once."""
    model = SPH3DSceneSeg(_tight_config(),
                          generator=torch.Generator().manual_seed(0))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    step = segmentation_step_factory(model, *make_optimizer(
        model.parameters(), "adam", LR), inner_masked=True)
    batch = _torch_batch()
    snapshot = [copy.deepcopy(x.state_dict())
                for x in (step.optimizer, step.scheduler)]
    metrics = step.train_step(batch)
    assert not bool(metrics["dense_ok"]) and metrics["dense_ok"].dim() == 0
    model.load_state_dict(state0)
    step.optimizer.load_state_dict(snapshot[0])
    step.scheduler.load_state_dict(snapshot[1])
    with _build.record_calls() as calls:
        fb = step.classic_fallback().train_step(batch)
    names = [name for name, _, _ in calls]
    assert (names.count("window_gather"),
            names.count("window_gather_bwd")) == (24, 24)
    assert bool(fb["dense_ok"])

    direct = SPH3DSceneSeg(_edge_config())
    direct.load_state_dict(state0)
    ref = segmentation_step_factory(direct, *make_optimizer(
        direct.parameters(), "adam", LR), inner_masked=True).train_step(
        batch)
    assert torch.equal(fb["loss"], ref["loss"])
    after = direct.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in model.state_dict().items())
    assert any(not torch.equal(v, state0[k]) for k, v in after.items())
    assert step.scheduler.last_epoch == 1


def test_checked_eval_step_reruns_failed_scene_batches(capsys):
    """``checked_eval_step`` serves a covered batch from the dense engine
    and a batch that breaks the windows from the per-edge engine, equal
    to a direct per-edge eval step; the fallback is built once."""
    batch = _torch_batch()
    gen = torch.Generator().manual_seed(0)
    covered = SPH3DSceneSeg(_config("float32"), generator=gen)
    factory = segmentation_step_factory(
        covered, *make_optimizer(covered.parameters()), inner_masked=True)
    with _build.record_calls() as calls:
        metrics = checked_eval_step(factory)(batch)
    assert bool(metrics["dense_ok"])
    assert "window_gather" not in [name for name, _, _ in calls]

    tight = SPH3DSceneSeg(_tight_config())
    tight.load_state_dict(covered.state_dict())
    factory = segmentation_step_factory(
        tight, *make_optimizer(tight.parameters()), inner_masked=True)
    run = checked_eval_step(factory)
    got = [run(batch) for _ in range(2)]
    assert not bool(tight.dense_ok)
    assert capsys.readouterr().out.count("re-running") == 1
    direct = SPH3DSceneSeg(_edge_config())
    direct.load_state_dict(covered.state_dict())
    ref = segmentation_step_factory(
        direct, *make_optimizer(direct.parameters()),
        inner_masked=True).eval_step(batch)
    for m in got:
        assert bool(m["dense_ok"])
        for k in ("loss", "data_loss", "logits", "item_loss"):
            assert torch.equal(m[k], ref[k]), k
