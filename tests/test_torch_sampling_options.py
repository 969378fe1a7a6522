"""PyTorch port vs JAX: the non-default sampling, pooling and unpooling
options of ``SPH3DConfig`` (``sample="IDS"|"random"``,
``pool_method="avg"``, ``unpool_method="weighted"``).

Torch cannot reproduce JAX's PRNG, so every test hands both sides the
same draws: the JAX samplers run as they are, on keys the test chooses
(inside a model, a wrapper around ``sph3d_gcn_tpu.nn.graph``'s samplers
replaces the model's per-level key by ``jax.random.key(N_level)``), and
the port gets the numbers ``jax.random.uniform`` / ``jax.random.randint``
draw from those keys, as numpy arrays.

- Samplers: ``inverse_density_sample`` (ties of ``log 0 = -inf`` rows
  included) and ``random_sample`` give JAX's indices exactly;
  ``build_graph`` (per-edge) and ``build_graph_dense`` with IDS and
  random sampling give JAX's sample indices exactly.
- Models: a narrow ``SPH3DModelNet`` (mlp 16, levels 16/32/32, B=2,
  N=1024) with IDS sampling and the avg pool on both engines, and a
  narrow ``SPH3DSceneSeg`` (mlp 16, levels 16/32/32/64, B=2, N=1024) with
  the weighted unpool, on numpy-seeded Flax weights carried across by
  ``utils.convert``: the ModelNet eval logits on both engines (f32
  rtol=atol=1e-4: f32 sums in other orders through the layers; the ops'
  bf16 paths are held per op by tests/test_torch_dist_maps.py) and one
  f32 train step of each model: loss (relative error 1e-5), logits (1e-4)
  and gradient leaves (relative L2 error 1e-2 each, the median leaf 1e-4,
  as tests/test_torch_seg_train.py). Random sampling through the ModelNet
  model: both engines' logits against JAX's per-edge engine where the
  dense certificate holds (the certificate proves the dense graph equal
  to the per-edge one); where it fails, ``checked_forward`` re-runs the
  batch on the per-edge engine with the same draws.

Each JAX model is traced and compiled once per module (its interpret-mode
Pallas kernels dominate the file's time).
"""

import contextlib
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
from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_tpu.models import SPH3DSceneSeg as JaxSceneSeg
from sph3d_gcn_tpu.nn import graph as jgraph
from sph3d_gcn_tpu.ops import sample as jsample
from sph3d_gcn_tpu.train.steps import (
    classification_step_factory as jax_cls_step_factory,
)
from sph3d_gcn_tpu.train.steps import (
    segmentation_step_factory as jax_seg_step_factory,
)
from sph3d_gcn_torch.configs import modelnet_config, s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DModelNet, SPH3DSceneSeg
from sph3d_gcn_torch.nn import graph as tgraph
from sph3d_gcn_torch.nn.layers import Dropout
from sph3d_gcn_torch.ops import sample as tsample
from sph3d_gcn_torch.train.eval import checked_forward
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import (
    classification_step_factory,
    segmentation_step_factory,
)
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_train import _leaves, _no_dropout, _rel

B, N = 2, 1024
TINY = float(np.finfo(np.float32).tiny)


def ids_draws(key, shape):
    """The uniforms JAX's ``inverse_density_sample`` draws from ``key``."""
    return np.array(jax.random.uniform(key, shape, minval=TINY, maxval=1.0))


def random_draws(key, batch, npoint, num):
    """The indices JAX's ``random_sample`` draws from ``key``."""
    return np.array(jax.random.randint(key, (batch, npoint), 0, num,
                                       dtype=jnp.int32))


def sorted_cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    return v[:, np.argsort(v[0, :, 0], kind="stable")]


# ------------------------------------------------------------- samplers


def test_inverse_density_sample_matches_jax():
    """Equal indices in the same order, zero probabilities (log 0 = -inf
    ties, more than are sampled past) going to the lower index first."""
    rng = np.random.default_rng(0)
    prob = rng.uniform(0.01, 1.0, (3, 500)).astype(np.float32)
    prob[:, rng.permutation(500)[:450]] = 0.0
    key = jax.random.key(5)
    ref = np.asarray(jsample.inverse_density_sample(100, jnp.asarray(prob),
                                                    key))
    u = ids_draws(key, prob.shape)
    got = tsample.inverse_density_sample(100, torch.from_numpy(prob),
                                         uniform=torch.from_numpy(u))
    assert got.dtype == torch.int64 and got.shape == (3, 100)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the 50 nonzero ones first, then the zero ones in index order
    tail = got[:, 50:].numpy()
    assert (np.diff(tail, axis=1) > 0).all()
    # drawn from a generator: reproducible, in range, no repeats
    g = [tsample.inverse_density_sample(
        100, torch.from_numpy(prob), torch.Generator().manual_seed(1))
        for _ in range(2)]
    assert torch.equal(g[0], g[1])
    assert all(len(set(row.tolist())) == 100 for row in g[0])


def test_random_sample_matches_jax():
    db = np.zeros((2, 300, 3), np.float32)
    key = jax.random.key(9)
    ref = np.asarray(jsample.random_sample(64, jnp.asarray(db), key))
    got = tsample.random_sample(64, torch.from_numpy(db),
                                indices=torch.from_numpy(
                                    random_draws(key, 2, 64, 300)))
    np.testing.assert_array_equal(got.numpy(), ref)
    drawn = tsample.random_sample(64, torch.from_numpy(db),
                                  torch.Generator().manual_seed(2))
    assert drawn.shape == (2, 64) and drawn.dtype == torch.int64
    assert 0 <= int(drawn.min()) and int(drawn.max()) < 300


@pytest.mark.parametrize("method", ["IDS", "random"])
@pytest.mark.parametrize("engine", ["per_edge", "dense"])
def test_build_graph_sample_indices_match_jax(engine, method):
    pts = sorted_cloud(1)
    key = jax.random.key(3)
    if method == "IDS":
        noise = ids_draws(key, (B, N))
    else:
        noise = random_draws(key, B, 256, N)
    t_noise = torch.from_numpy(noise)
    if engine == "dense":
        _, ref = jgraph.build_graph_dense(
            jnp.asarray(pts), 0.2, 32, 256, sample_method=method, key=key,
            kernel=(8, 2, 2), window=512)
        nbh, got = tgraph.build_graph_dense(
            torch.from_numpy(pts), 0.2, 32, 256, sample_method=method,
            kernel=(8, 2, 2), window=512, noise=t_noise)
        assert (nbh.dist is not None) == (method == "IDS")
        assert (torch.diff(got, dim=1) >= 0).all()      # sorted
    else:
        _, _, ref = jgraph.build_graph(
            jnp.asarray(pts), 0.2, 32, 256, sample_method=method, key=key,
            kernel=(8, 2, 2))
        _, _, got = tgraph.build_graph(
            torch.from_numpy(pts), 0.2, 32, 256, sample_method=method,
            kernel=(8, 2, 2), noise=t_noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------- models


@contextlib.contextmanager
def level_keys():
    """JAX's samplers inside the models draw from ``key(N_level)``."""
    ids, rnd = jgraph.inverse_density_sample, jgraph.random_sample
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgraph, "inverse_density_sample",
                   lambda n, prob, key: ids(
                       n, prob, jax.random.key(prob.shape[1])))
        mp.setattr(jgraph, "random_sample",
                   lambda n, xyz, key: rnd(
                       n, xyz, jax.random.key(xyz.shape[1])))
        yield


def level_noise(cfg):
    """Per level, the draws of :func:`level_keys` for the port."""
    sizes = (cfg.num_input,) + tuple(cfg.num_sample[:-1])
    if cfg.sample == "IDS":
        return [torch.from_numpy(ids_draws(jax.random.key(n), (B, n)))
                for n in sizes]
    return [torch.from_numpy(random_draws(jax.random.key(n), B, s, n))
            for n, s in zip(sizes, cfg.num_sample)]


def _fill(shapes, seed):
    """Numpy-seeded values for a Flax variable tree: He-scaled weights, BN
    terms near 1 / 0."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("weights", "depthwise_weights"):
            fan = s.shape[-2] * int(np.prod(s.shape[:-2]))
            scale = np.float32(np.sqrt(2.0 / fan))
            return rng.standard_normal(s.shape).astype(np.float32) * scale
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def mn_config(factory, dtype="float32", dense=True, **kw):
    """Narrow ModelNet: published structure, small widths, N=1024."""
    kw = dict(dict(sample="IDS", pool_method="avg"), **kw)
    return dataclasses.replace(
        factory(), num_input=N, num_sample=(256, 64, 16), mlp=16,
        channels=((16, 16), (16, 32), (32, 32)), global_channels=64,
        windows=(512, 256, 128), dense_graph=dense, spatial_sort=True,
        compute_dtype=dtype, **kw)


def seg_config(factory, dtype="float32"):
    """Narrow S3DIS: published structure, small widths, N=1024, the
    widened windows of tests/test_torch_segmentation.py."""
    return dataclasses.replace(
        factory(num_input=N, fast=True, dense=True), mlp=16,
        channels=((16, 16), (32, 32), (32, 32), (64, 64)),
        windows=(768, 512, 256, 128), dec_windows=(512,) * 4,
        growth_steps=12, dec_margin=384, compute_dtype=dtype,
        unpool_method="weighted")


def mn_points():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((B, N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rng.uniform(0.3, 1.0, (B, 1, 3)).astype(np.float32)


def seg_points():
    return scene_blocks(np.random.default_rng(3), B, N)


MODELS = {
    "modelnet": (JaxModelNet, SPH3DModelNet, mn_config, jax_modelnet_config,
                 modelnet_config, mn_points),
    "scene": (JaxSceneSeg, SPH3DSceneSeg, seg_config, jax_s3dis_config,
              s3dis_config, seg_points),
}


@functools.lru_cache(maxsize=None)
def variables(family):
    """Numpy-seeded Flax variables, in the tree that the port's model maps
    to (JAX's apply raises on a tree that lacks one of its variables or
    holds one of another shape)."""
    _, tmodel, config, _, factory, _ = MODELS[family]
    return _fill(flax_tree_from_torch(tmodel(config(factory)).state_dict()),
                 1)


def torch_model(family, cfg):
    model = MODELS[family][1](cfg)
    model.load_state_dict(
        torch_state_dict_from_flax(variables(family), model.state_dict()))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


@functools.lru_cache(maxsize=None)
def jax_logits(dense=True, sample="IDS"):
    """The narrow JAX ModelNet's f32 eval logits and certificate."""
    jcfg = mn_config(jax_modelnet_config, dense=dense, sample=sample)
    with level_keys():
        out, inter = jax.jit(lambda v, p: JaxModelNet(jcfg).apply(
            v, p, rngs={"sample": jax.random.key(2)},
            mutable=["intermediates"]))(variables("modelnet"), mn_points())
    # the per-edge engine sows no certificate: it is exact for every cloud
    ok = all(jax.tree_util.tree_leaves(inter.get("intermediates", {})))
    return np.asarray(out), bool(ok)


# the scene model's logits are held to JAX's by its train step below (in
# train mode); the weighted unpool and the avg pools in bf16 by
# tests/test_torch_dist_maps.py
@pytest.mark.parametrize("dense", [True, False])
def test_modelnet_option_logits_match_jax(dense):
    tol = 1e-4
    ref, ref_ok = jax_logits(dense)
    cfg = mn_config(modelnet_config, dense=dense)
    model = torch_model("modelnet", cfg).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(mn_points()),
                    sample_noise=level_noise(cfg))
    assert bool(model.dense_ok) == ref_ok
    assert np.abs(ref).max() > 0.1          # logits are not vanishing
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


@functools.lru_cache(maxsize=None)
def jax_step(family):
    """JAX's (loss, logits, ok, grads) of one f32 train step, dropout
    intercepted, the sampling keys of :func:`level_keys`."""
    jmodel, _, config, jfactory, _, points = MODELS[family]
    jcfg = config(jfactory)
    pts = points()
    rng = np.random.default_rng(7)
    if family == "modelnet":
        sf = jax_cls_step_factory(jmodel(jcfg), optax.adam(1e-3),
                                  weight_decay=jcfg.weight_decay)
        batch = {"points": jnp.asarray(pts),
                 "label": jnp.asarray(np.array([3, 17], np.int32))}
    else:
        sf = jax_seg_step_factory(jmodel(jcfg), optax.adam(1e-3),
                                  inner_masked=True)
        batch = {"points": jnp.asarray(pts),
                 "label": jnp.asarray(rng.integers(0, 13, (B, N)),
                                      jnp.int32),
                 "inner_label": jnp.asarray(rng.integers(0, 2, (B, N)),
                                            jnp.int32)}
    v = variables(family)

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    with fnn.intercept_methods(_no_dropout), level_keys():
        (total, (_, logits, _, ok, _)), grads = jax.jit(
            jax.value_and_grad(losses, has_aux=True)
        )(v["params"], v["batch_stats"])
    return total, logits, bool(ok), dict(_leaves(grads)), {
        k: np.asarray(x) for k, x in batch.items()}


@pytest.mark.parametrize("family", ["modelnet", "scene"])
def test_option_train_step_matches_jax(family):
    total, logits, ok, ref, batch = jax_step(family)
    _, _, config, _, factory, _ = MODELS[family]
    cfg = config(factory)
    model = torch_model(family, cfg)
    opt, sch = make_optimizer(model.parameters(), "adam", 1e-3)
    if family == "modelnet":
        step = classification_step_factory(model, opt, sch,
                                           weight_decay=cfg.weight_decay)
    else:
        step = segmentation_step_factory(model, opt, sch, inner_masked=True)
    metrics = step.loss_and_grads(
        {k: torch.from_numpy(v.copy()) for k, v in batch.items()},
        sample_noise=level_noise(cfg))
    assert bool(metrics["dense_ok"]) == ok
    assert _rel(metrics["loss"], total) < 1e-5
    assert _rel(metrics["logits"], logits) < 1e-4
    ours = dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    assert set(ours) == set(ref)
    errs = {k: _rel(ours[k], ref[k]) for k in ref}
    assert np.median(list(errs.values())) < 1e-4
    bad = {k: e for k, e in errs.items() if not e < 1e-2}
    assert not bad, bad


def test_random_sampling_model_matches_jax_or_falls_back():
    """ModelNet with random sampling (with replacement: the coarse clouds
    hold repeated points): the per-edge engine's logits against JAX's;
    the dense engine's against the same where its certificate holds,
    else ``checked_forward`` serves the batch on the per-edge engine from
    the generator state the dense forward drew from."""
    ref, _ = jax_logits(False, "random")
    cfg = mn_config(modelnet_config, sample="random", dense=False)
    noise = level_noise(cfg)
    model = torch_model("modelnet", cfg).eval()
    x = torch.from_numpy(mn_points())
    with torch.no_grad():
        got = model(x, sample_noise=noise)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    dense = torch_model("modelnet", dataclasses.replace(cfg,
                                                        dense_graph=True))
    dense.eval()
    with torch.no_grad():
        got_dense = dense(x, sample_noise=noise)
    if bool(dense.dense_ok):
        np.testing.assert_allclose(got_dense.numpy(), ref, rtol=1e-4,
                                   atol=1e-4)
    # served from a generator: the answer is the one of the engine that
    # the certificate picks, on the draws of the generator's state before
    # the dense forward (a failed certificate re-runs on the same draws)
    served = checked_forward(dense, "cpu", torch.Generator().manual_seed(4))
    out = served(mn_points())
    engine = dense if bool(dense.dense_ok) else model
    with torch.no_grad():
        direct = engine(x, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(out, direct.numpy())
