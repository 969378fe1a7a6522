"""PyTorch port vs JAX: the ShapeNet part-segmentation models, their
config, records and eval protocol.

``SPH3DShapeNet`` (per category, here 4 parts) and
``SPH3DShapeNetOnehot`` (50 parts, the category one-hot before the
logits) on ``shapenet_config(fast=True, dense=True)`` at its published
channels (mlp 64, levels 128/256/256/512, r=2, kernel (8, 2, 2), K=64,
radii 0.08-0.64), cut to B=2, N=512 (levels 512 -> 256 -> 192 -> 96 ->
32, a quarter of the published 2048 -> 1024 -> 768 -> 384 -> 128) with
windows that cover these clouds (unit-sphere normalized ellipsoid
surfaces, as ShapeNet's data preparation normalizes its shapes), so the
decoder's second block still sees C_in = 1024, an inter graph grows its
radius, and the backbone ends in the input skip and ``mlp2``. Numpy-seeded weights in
the Flax tree layout go through the JAX model and, carried across by
``utils.convert``, through the port. Each JAX model or step is built
once per module.

Tolerances, as tests/test_torch_segmentation.py and
tests/test_torch_seg_train.py: f32 logits rtol=atol=1e-4; bf16 logits
rtol=atol=5e-2 with equal argmax; the f32 train step's loss 1e-5, logits
1e-4, each gradient leaf's relative L2 error 1e-2 with the median leaf
1e-4, new BN statistics 1e-5; the per-edge engine's f32 logits within
2e-3 of the largest |logit| with equal argmax, as
tests/test_torch_seg_per_edge.py holds the scene model's. The records
reader and the coverage protocol equal JAX's exactly.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sph3d_gcn_tpu.configs import shapenet_config as jax_shapenet_config
from sph3d_gcn_tpu.data.prep.shapenet import (
    load_shapenet_records as jax_load_shapenet_records,
)
from sph3d_gcn_tpu.data.prep.shapenet import make_shapenet_records
from sph3d_gcn_tpu.models import SPH3DShapeNet as JaxShapeNet
from sph3d_gcn_tpu.models import SPH3DShapeNetOnehot as JaxShapeNetOnehot
from sph3d_gcn_tpu.train import eval as jax_eval
from sph3d_gcn_tpu.train.steps import (
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.configs import shapenet_config
from sph3d_gcn_torch.data.prep.shapenet import load_shapenet_records
from sph3d_gcn_torch.data.synthetic import surface_clouds
from sph3d_gcn_torch.models import SPH3DShapeNet, SPH3DShapeNetOnehot
from sph3d_gcn_torch.models.common import classic_clone
from sph3d_gcn_torch.ops import query as Q
from sph3d_gcn_torch.train import eval as torch_eval
from sph3d_gcn_torch.train.loop import fit, step_generator
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import segmentation_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_configs_data import assert_same_config
from test_torch_seg_train import STEP_TOL
from test_torch_train import _leaves, _rel

B, N = 2, 512
NUM_SAMPLE = (256, 192, 96, 32)
PARTS = 4                      # the per-category model's parts (a chair)
CLS_LABEL = np.array([4, 12], np.int32)
LR = 1e-3
EDGE_TOL = 2e-3                # of the largest |logit|, the per-edge engine

# name -> (JAX model, port model, part count, extra model inputs)
MODELS = {
    "category": (JaxShapeNet, SPH3DShapeNet, PARTS, ()),
    "onehot": (JaxShapeNetOnehot, SPH3DShapeNetOnehot, 50, (CLS_LABEL,)),
}


def _config(dtype, factory=shapenet_config, **kw):
    return dataclasses.replace(
        factory(num_input=N, fast=True, dense=True), num_sample=NUM_SAMPLE,
        windows=(384, 256, 256, 128), dec_windows=(256, 256, 128, 128),
        dec_margin=128, growth_steps=3, compute_dtype=dtype, **kw)


@functools.lru_cache(maxsize=None)
def _points():
    """Unit-sphere normalized ellipsoid surfaces (the offline
    normalization of ShapeNet's data preparation)."""
    pts = surface_clouds(np.random.default_rng(11), B, N)
    pts -= pts.mean(axis=1, keepdims=True)
    pts /= np.sqrt((pts ** 2).sum(-1)).max(axis=1)[:, None, None]
    return pts.astype(np.float32)


def _jax_model(name, cfg):
    jax_cls, _, parts, _ = MODELS[name]
    return jax_cls(cfg, num_cls=parts)


@functools.lru_cache(maxsize=None)
def _variables(name):
    """The JAX model's variable tree (shapes from tracing init), filled
    with numpy-seeded values: He-scaled weights, BN terms near 1 / 0."""
    extra = MODELS[name][3]
    shapes = jax.eval_shape(
        lambda p, *e: _jax_model(
            name, _config("float32", jax_shapenet_config)).init(
                jax.random.key(0), p, *e), _points(), *extra)
    return seeded_variables(shapes, np.random.default_rng(12))


def seeded_variables(shapes, rng):
    """A Flax variable tree of ``shapes`` filled from ``rng``: He-scaled
    weights, BN scales and variances in [0.5, 1.5), other terms near 0."""
    def fill(path, s):
        leaf = path[-1].key
        if leaf in ("weights", "depthwise_weights"):
            fan = s.shape[-2] * int(np.prod(s.shape[:-2]))
            scale = np.float32(np.sqrt(2.0 / fan))
            return rng.standard_normal(s.shape).astype(np.float32) * scale
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(name, cfg):
    _, port_cls, parts, _ = MODELS[name]
    model = port_cls(cfg, num_cls=parts)
    model.load_state_dict(
        torch_state_dict_from_flax(_variables(name), model.state_dict()))
    return model


def _port_inputs(name):
    return [torch.from_numpy(_points())] + [
        torch.from_numpy(e) for e in MODELS[name][3]]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("name", list(MODELS))
def test_shapenet_logits_match_jax(name, dtype, tol):
    jcfg = _config(dtype, jax_shapenet_config)
    ref, inter = jax.jit(lambda v, p, *e: _jax_model(name, jcfg).apply(
        v, p, *e, mutable=["intermediates"]))(
            _variables(name), _points(), *MODELS[name][3])
    (ref_ok,) = jax.tree_util.tree_leaves(inter["intermediates"])
    model = _port_model(name, _config(dtype)).eval()
    with _build.record_calls() as calls, torch.no_grad():
        got = model(*_port_inputs(name))
    assert got.dtype == torch.float32
    assert got.shape == (B, N, MODELS[name][2])
    assert bool(model.dense_ok) and bool(ref_ok)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1          # logits are not vanishing
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
    # every kernel-wrapped call of the scene models' dense path, and every
    # conv width, the decoder's C_in = 1024 included
    names = [n for n, _, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {
        "fps": 4, "dense_query": 12, "growth_query": 4, "dense_conv": 16,
        "rank_pool": 4, "mean_interpolate": 4}
    widths = sorted({args[2].shape[-1] for n, args, _ in calls
                     if n == "dense_conv"})
    assert widths == [64, 128, 256, 512, 1024]
    # the decoders' inter graphs grew the radius of some rows
    grown = [Q.growth_query_plain(*args, **kw)[1] for n, args, kw in calls
             if n == "growth_query"]
    assert max(int(s.max()) for s in grown) > 0


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_maps_every_leaf(name):
    """Every leaf of the JAX tree has its port key and none is left over
    (the converter raises otherwise): ``backbone/mlp2`` by name, and the
    logits at the input skip's width (64 + 64, and the one-hot's 16)."""
    model = _port_model(name, _config("float32"))
    sd = torch_state_dict_from_flax(_variables(name), model.state_dict())
    assert set(sd) == set(model.state_dict())
    ref = dict(_leaves(_variables(name)["params"]))
    np.testing.assert_array_equal(
        sd["backbone.mlp2.weights"].numpy(),
        np.asarray(ref[("backbone", "mlp2", "weights")]))
    assert sd["backbone.mlp2.weights"].shape == (256, 64)
    width = 128 + (16 if name == "onehot" else 0)
    assert sd["logits.weights"].shape == (width, MODELS[name][2])
    assert model.backbone.out_channels == 128
    back = flax_tree_from_torch(sd)
    assert set(k for k, _ in _leaves(back["params"])) == set(ref)
    assert (set(k for k, _ in _leaves(back["batch_stats"]))
            == set(k for k, _ in _leaves(_variables(name)["batch_stats"])))


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(13)
    return _points(), rng.integers(0, 50, (B, N)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's (loss, data loss, logits, new stats, ok, grads) of one
    one-hot f32 train step (the plain mean loss)."""
    pts, labels = _batch()
    sf = jax_seg_step_factory(
        _jax_model("onehot", _config("float32", jax_shapenet_config)),
        optax.adam(LR), model_kwargs_keys=("cls_label",))
    batch = {"points": jnp.asarray(pts), "label": jnp.asarray(labels),
             "cls_label": jnp.asarray(CLS_LABEL)}
    variables = _variables("onehot")

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    (total, (data_loss, logits, new_stats, ok, _)), grads = jax.jit(
        jax.value_and_grad(losses, has_aux=True)
    )(variables["params"], variables["batch_stats"])
    return total, data_loss, logits, new_stats, ok, grads


def test_onehot_train_step_matches_jax():
    tol = STEP_TOL["float32"]
    total, data_loss, logits, new_stats, ok, grads = _jax_step()
    model = _port_model("onehot", _config("float32"))
    step = segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", LR),
        model_kwargs_keys=("cls_label",))
    pts, labels = _batch()
    batch = {"points": torch.from_numpy(pts),
             "label": torch.from_numpy(labels),
             "cls_label": torch.from_numpy(CLS_LABEL)}
    with _build.record_calls() as calls:
        metrics = step.loss_and_grads(batch)
    names = [n for n, _, _ in calls]
    assert (names.count("dense_conv_bwd"), names.count("rank_pool_bwd"),
            names.count("mean_interpolate_bwd")) == (16, 4, 4)
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
    # the one-hot's logits rows and mlp2 take gradient
    assert np.abs(ours[("logits", "weights")][128:]).max() > 0
    assert np.abs(ours[("backbone", "mlp2", "weights")]).max() > 0
    stats = dict(_leaves(flax_tree_from_torch(
        {k: v for k, v in model.state_dict().items()
         if k.endswith((".mean", ".var"))})["batch_stats"]))
    ref_stats = dict(_leaves(new_stats))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])


def test_per_edge_forward_matches_jax():
    """The one-hot model on the per-edge engine (``dense_graph=False``)
    against JAX's, whose side runs without row windows (its plain gather:
    the same function without an interpret-mode kernel to compile); the
    dense model's ``classic_clone`` (the fallback's engine, ``mlp2``
    and the one-hot head included) equals the per-edge model bitwise."""
    jcfg = dataclasses.replace(
        _config("float32", jax_shapenet_config, dense_graph=False),
        windows=None, dec_windows=None)
    ref = np.asarray(jax.jit(lambda v, p, c: _jax_model("onehot", jcfg)
                             .apply(v, p, c))(
        _variables("onehot"), _points(), CLS_LABEL))
    model = _port_model("onehot", _config("float32", dense_graph=False))
    with _build.record_calls() as calls, torch.no_grad():
        got = model.eval()(*_port_inputs("onehot"))
    names = [n for n, _, _ in calls]
    assert (names.count("fps"), names.count("window_gather")) == (4, 24)
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=EDGE_TOL * scale)
    assert (got.numpy().argmax(-1) == ref.argmax(-1)).all()
    dense = _port_model("onehot", _config("float32"))
    clone = classic_clone(dense.eval())
    assert clone.backbone.mlp2 is dense.backbone.mlp2
    with torch.no_grad():
        again = clone(*_port_inputs("onehot"))
    assert torch.equal(again, got)


def _onehot_factory(cfg, state):
    model = SPH3DShapeNetOnehot(cfg)
    model.load_state_dict(state)
    return segmentation_step_factory(
        model, *make_optimizer(model.parameters(), "adam", LR),
        model_kwargs_keys=("cls_label",))


def test_fit_reruns_a_failed_onehot_batch_with_its_categories(tmp_path):
    """``fit`` on a one-hot batch whose windows fail the certificate: the
    device copy carries ``cls_label``, the batch is restored and re-run
    through ``classic_fallback()`` with it, and the model ends bitwise
    equal to a direct per-edge step; the eval pass's re-run too. A step
    with other categories differs (the one-hot reaches the logits)."""
    tight = dataclasses.replace(_config("float32"), windows=(128,) * 4,
                                dec_windows=(128,) * 4, growth_steps=1)
    state0 = {k: v.clone() for k, v in SPH3DShapeNetOnehot(
        tight, generator=torch.Generator().manual_seed(1)).state_dict().items()}
    pts, labels = _batch()
    batch = {"points": pts, "label": labels, "cls_label": CLS_LABEL}
    factory = _onehot_factory(tight, state0)
    fit(factory, lambda epoch: iter([batch]), lambda: iter([batch]), B, 1,
        str(tmp_path), seed=4)
    log = (tmp_path / "log_train.txt").read_text()
    assert "during epoch 0 batch 0 (violation #1); re-running via the " \
           "classic engine" in log
    assert "violations total: 2 (all re-run" in log
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    edge = dataclasses.replace(tight, dense_graph=False)
    direct = _onehot_factory(edge, state0)
    direct.train_step(tensors, step_generator(4, 0, "cpu"))
    ref = direct.model.state_dict()
    assert all(torch.equal(v, ref[k])
               for k, v in factory.model.state_dict().items())
    other = _onehot_factory(edge, state0)
    other.train_step(dict(tensors, cls_label=torch.tensor([0, 1])),
                     step_generator(4, 0, "cpu"))
    assert not torch.equal(other.model.state_dict()["logits.weights"],
                           ref["logits.weights"])


@pytest.mark.parametrize("kw", [
    {},
    {"fast": True},
    {"fast": True, "dense": True},
    {"num_input": 1024, "fast": True, "dense": True},
])
def test_shapenet_config_matches_jax(kw):
    assert_same_config(shapenet_config(**kw), jax_shapenet_config(**kw))


def test_load_shapenet_records_matches_jax(tmp_path):
    """Records written by the JAX package's writer read back equal through
    both readers (0-based labels, the xzy -> xyz swap undone by neither)."""
    rng = np.random.default_rng(14)
    shapes = []
    for cls_id, n in ((4, 300), (12, 257), (4, 129)):
        part = rng.integers(1, 4, n).astype(np.int32)
        shapes.append((rng.standard_normal((n, 3)).astype(np.float32),
                       part, cls_id))
    offsets = {4: 12, 12: 38}
    paths = [str(tmp_path / "a.tfrecord"), str(tmp_path / "b.tfrecord")]
    make_shapenet_records(shapes[:2], offsets, paths[0])
    make_shapenet_records(shapes[2:], offsets, paths[1])
    got = load_shapenet_records(paths)
    ref = jax_load_shapenet_records(paths)
    assert len(got) == len(ref) == 3
    for g, r, (xyz, part, cls_id) in zip(got, ref, shapes):
        assert set(g) == set(r) == {"xyz", "part_label", "seg_label",
                                    "cls_label"}
        for key in ("xyz", "part_label", "seg_label"):
            assert g[key].dtype == r[key].dtype
            np.testing.assert_array_equal(g[key], r[key])
        assert g["cls_label"] == r["cls_label"] == cls_id
        np.testing.assert_array_equal(g["xyz"], xyz[:, [0, 2, 1]])
        np.testing.assert_array_equal(g["part_label"], part - 1)
        np.testing.assert_array_equal(g["seg_label"],
                                      part + offsets[cls_id] - 1)


def _fake_forward(calls):
    """A deterministic forward: logits from the points (and the block ids),
    recording every call."""
    def fn(x, ids=None):
        calls.append((np.array(x), None if ids is None else list(ids)))
        bias = 0 if ids is None else np.asarray(ids)[:, None, None]
        return np.concatenate([x[..., :3] * 2 + bias, x[..., :2] ** 2], -1)
    return fn


def _shapes(rng):
    return [(rng.standard_normal((p, 3)).astype(np.float32),
             (rng.uniform(size=p) < 0.7).astype(np.int32))
            for p in (40, 70, 25, 55)]


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


# (N, B, max_rounds): blocks below and above N, partial batches, rounds
# that run out before 11 samples a point and that do not
@pytest.mark.parametrize("n_model,batch,max_rounds",
                         [(48, 2, None), (30, 3, 5), (64, 5, 40)])
def test_coverage_eval_blocks_options_match_jax(n_model, batch, max_rounds):
    blocks = _shapes(np.random.default_rng(15))
    seen = {"jax": [], "torch": []}
    kw = dict(max_rounds=max_rounds, min_count=11)
    ref, ref_warn = _warned(lambda: jax_eval.coverage_eval_blocks(
        _fake_forward(seen["jax"]), blocks, n_model, batch,
        rng=np.random.default_rng(16), augment_fn=jax_eval.shapenet_eval_augment,
        **kw))
    got, got_warn = _warned(lambda: torch_eval.coverage_eval_blocks(
        _fake_forward(seen["torch"]), blocks, n_model, batch,
        rng=np.random.default_rng(16),
        augment_fn=torch_eval.shapenet_eval_augment, **kw))
    assert len(got) == len(ref) == len(blocks)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert len(seen["torch"]) == len(seen["jax"]) > 2
    for (a, ia), (b, ib) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
        assert ia == ib
    assert got_warn == ref_warn
    assert bool(got_warn) == (max_rounds == 5)


@pytest.mark.parametrize("max_rounds,augment", [(None, True), (4, True),
                                                (30, False)])
def test_coverage_eval_block_matches_jax(max_rounds, augment):
    pts, inner = _shapes(np.random.default_rng(17))[1]
    seen = {"jax": [], "torch": []}
    ref, ref_warn = _warned(lambda: jax_eval.coverage_eval_block(
        _fake_forward(seen["jax"]), pts, inner, 48,
        rng=np.random.default_rng(18), max_rounds=max_rounds, min_count=11,
        augment_fn=jax_eval.shapenet_eval_augment if augment else None))
    got, got_warn = _warned(lambda: torch_eval.coverage_eval_block(
        _fake_forward(seen["torch"]), pts, inner, 48,
        rng=np.random.default_rng(18), max_rounds=max_rounds, min_count=11,
        augment_fn=torch_eval.shapenet_eval_augment if augment else None))
    np.testing.assert_array_equal(got, ref)
    assert len(seen["torch"]) == len(seen["jax"])
    for (a, _), (b, _) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert got_warn == ref_warn
    assert bool(got_warn) == (max_rounds == 4)


def test_shapenet_eval_augment_matches_jax():
    x = np.random.default_rng(19).standard_normal((3, 40, 3)).astype(
        np.float32)
    got = torch_eval.shapenet_eval_augment(x.copy(),
                                           np.random.default_rng(20))
    ref = jax_eval.shapenet_eval_augment(x.copy(), np.random.default_rng(20))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_shapenet_train_augment_moves_categories_with_shapes():
    """With the batch's categories, the ShapeNet policy draws as JAX's does
    and returns the same points and labels, and the categories in the
    shuffled item order (JAX's one-hot script keeps them unshuffled)."""
    from sph3d_gcn_tpu.train.augment_policies import (
        shapenet_train_augment as jax_augment,
    )
    from sph3d_gcn_torch.train.augment_policies import shapenet_train_augment

    rng = np.random.default_rng(21)
    pts = rng.standard_normal((6, 50, 3)).astype(np.float32)
    lbl = rng.integers(0, 50, (6, 50)).astype(np.int32)
    cls = np.arange(6, dtype=np.int32) * 2
    got = shapenet_train_augment(pts.copy(), lbl.copy(),
                                 np.random.default_rng(22), cls)
    ref = jax_augment(pts.copy(), lbl.copy(), np.random.default_rng(22))
    two = shapenet_train_augment(pts.copy(), lbl.copy(),
                                 np.random.default_rng(22))
    for g, r, t in zip(got, ref, two):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(t, r)
    order = np.random.default_rng(22).permutation(6)
    np.testing.assert_array_equal(got[2], cls[order])
    assert not np.array_equal(order, np.arange(6))
