"""PyTorch port vs JAX: the per-edge engine of ``fast=True, dense=False``.

The edge gather (``windowed_gather_padded``), the conv and the max pool
with and without a window, the fused sphere query with bins, and the whole
ModelNet40 model on that engine (serving forward and train step). JAX runs
its Pallas one-hot kernels in interpret mode on the CPU; the port runs the
plain twins of K8 and K9 (the kernels are held against these on the card,
tests/test_torch_dispatch.py). Inputs come from numpy seeds.

Tolerances:

- gather values: bitwise equal, zero lanes and padded rows included (the
  JAX one-hot product of a single 1 is exact);
- gather gradients, relative L2 error: f32 1e-6 (sums in other orders);
  bf16 held to JAX's f32 gradient, no worse than JAX's own bf16 gradient
  or one bf16 rounding (2^-8), whichever is larger (JAX rounds each
  edge chunk's window sums and the block scatter to bf16, the port sums
  in f32 and rounds once);
- conv: f32 values and gradients rtol=atol=1e-5; bf16 values within 2e-2
  (one rounding of the outputs and of the bin sums, in other orders), bf16
  gradients held to the f32 ones as the gather's;
- max pool: values, ``max_index`` and gradients exact, on integer-valued
  features (ties everywhere in bf16) with an integer cotangent;
- query: idx and count exact, dist rtol=atol=1e-5, bins exact.
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
from sph3d_gcn_tpu.ops.conv import depthwise_conv3d as j_conv
from sph3d_gcn_tpu.ops.neighbor import (
    build_sphere_neighbor_and_bins as j_query_bins,
)
from sph3d_gcn_tpu.ops.pool import max_pool3d as j_max_pool
from sph3d_gcn_tpu.ops.windowed import windowed_gather as j_gather_unpadded
from sph3d_gcn_tpu.ops.windowed import windowed_gather_padded as j_gather
from sph3d_gcn_tpu.train.steps import (
    classification_step_factory as jax_step_factory,
)
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.configs import modelnet_config
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.nn.layers import Dropout
from sph3d_gcn_torch.ops import neighbor as tn
from sph3d_gcn_torch.ops.conv import depthwise_conv3d
from sph3d_gcn_torch.ops.kernelbin import spherical_kernel
from sph3d_gcn_torch.ops.pool import max_pool3d
from sph3d_gcn_torch.ops.windowed import (
    windowed_gather,
    windowed_gather_padded,
)
from sph3d_gcn_torch.train.eval import checked_forward
from sph3d_gcn_torch.train.schedule import make_optimizer
from sph3d_gcn_torch.train.steps import classification_step_factory
from sph3d_gcn_torch.utils.convert import (
    flax_tree_from_torch,
    torch_state_dict_from_flax,
)
from test_torch_dispatch import fallback_case
from test_torch_modelnet import (  # the serving-forward test's inputs
    B,
    N,
    _flax_variables,
    _points,
    variables,  # noqa: F401  (module-scoped fixture)
)
from test_torch_train import LABELS, STEP_TOL, _leaves, _no_dropout, _rel

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def local_edges(rng, b, n, m, k, spread):
    """Sorted-ish neighbor indices with a bounded spread (the windowed
    regime), counts in [1, K]."""
    base = np.sort(rng.integers(0, n, (b, m)))
    idx = np.clip(base[..., None] + rng.integers(-spread, spread, (b, m, k)),
                  0, n - 1)
    count = rng.integers(1, k + 1, (b, m))
    return idx.astype(np.int32), count.astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# name: (b, n, c, m, k, spread, window); "overflow" puts one tile's
# neighbors at both ends of the cloud, so JAX takes its plain-gather path
GATHER_CASES = {
    "w128": (2, 300, 7, 260, 9, 30, 128),
    "w256": (2, 300, 5, 200, 6, 60, 256),
    "w_ge_n": (1, 300, 8, 140, 5, 80, 512),
    "overflow": (1, 400, 6, 256, 4, 10, 128),
}


def _gather_inputs(case, seed=0):
    b, n, c, m, k, spread, window = GATHER_CASES[case]
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    idx, count = local_edges(rng, b, n, m, k, spread)
    if case == "overflow":
        idx[0, 0, 0], idx[0, 1, 0] = n - 1, 0
        count[0, :2] = k
    m_pad = -(-m // 128) * 128
    cot = rng.standard_normal((b, m_pad, k, c)).astype(np.float32)
    return feats, idx, count, window, cot


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_windowed_gather_matches_jax(case, dtype):
    jdt, tdt = DTYPES[dtype]
    feats, idx, count, window, _ = _gather_inputs(case)
    ref, ref_valid = j_gather(jnp.asarray(feats, jdt), jnp.asarray(idx),
                              jnp.asarray(count), window=window)
    got, valid = windowed_gather_padded(
        torch.from_numpy(feats).to(tdt), torch.from_numpy(idx),
        torch.from_numpy(count), window=window)
    assert got.dtype == tdt and got.shape == ref.shape
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    # bitwise, through the f32 view of exact values (bf16 widens exactly)
    np.testing.assert_array_equal(_f32(got).view(np.uint32),
                                  _f32(ref).view(np.uint32))
    assert (_f32(got)[~valid.numpy()] == 0).all()
    m = idx.shape[1]
    np.testing.assert_array_equal(
        _f32(windowed_gather(torch.from_numpy(feats).to(tdt),
                             torch.from_numpy(idx), torch.from_numpy(count),
                             window=window)),
        _f32(j_gather_unpadded(jnp.asarray(feats, jdt), jnp.asarray(idx),
                               jnp.asarray(count), window=window)))
    assert _f32(got)[:, m:].max(initial=0) == 0


@pytest.mark.parametrize("case", ["w128", "overflow"])
def test_windowed_gather_grads_match_jax(case):
    feats, idx, count, window, cot = _gather_inputs(case, seed=1)

    def jax_grad(jdt):
        f = jnp.asarray(feats, jdt)
        _, vjp = jax.vjp(lambda x: j_gather(x, jnp.asarray(idx),
                                            jnp.asarray(count),
                                            window=window)[0], f)
        return _f32(vjp(jnp.asarray(cot, jdt))[0])

    def port_grad(tdt):
        f = torch.from_numpy(feats).to(tdt).requires_grad_()
        g, _ = windowed_gather_padded(f, torch.from_numpy(idx),
                                      torch.from_numpy(count), window=window)
        g.backward(torch.from_numpy(cot).to(tdt))
        assert f.grad.dtype == tdt
        return _f32(f.grad)

    ref32 = jax_grad(jnp.float32)
    assert np.abs(ref32).max() > 0
    assert _rel(port_grad(torch.float32), ref32) < 1e-6
    jax_err = _rel(jax_grad(jnp.bfloat16), ref32)
    assert _rel(port_grad(torch.bfloat16), ref32) <= max(jax_err, 2.0 ** -8)


def _conv_inputs(seed=3):
    rng = np.random.default_rng(seed)
    b, n, c, m, k, f_bins, mult = 2, 260, 8, 250, 7, 9, 2
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    filt = rng.standard_normal((f_bins, c, mult)).astype(np.float32)
    idx, count = local_edges(rng, b, n, m, k, spread=25)
    bins = rng.integers(0, f_bins, (b, m, k)).astype(np.int32)
    cot = rng.standard_normal((b, m, c * mult)).astype(np.float32)
    return feats, filt, idx, count, bins, cot


@pytest.mark.parametrize("window", [128, None])
def test_depthwise_conv_matches_jax(window):
    feats, filt, idx, count, bins, cot = _conv_inputs()
    graph = (jnp.asarray(idx), jnp.asarray(count), jnp.asarray(bins))

    def jax_run(jdt):
        def f(x, w):
            return j_conv(x, w, *graph, window=window)

        out, vjp = jax.vjp(f, jnp.asarray(feats, jdt), jnp.asarray(filt))
        dx, dw = vjp(jnp.asarray(cot, jdt))
        return _f32(out), _f32(dx), _f32(dw)

    def port_run(tdt):
        x = torch.from_numpy(feats).to(tdt).requires_grad_()
        w = torch.from_numpy(filt).requires_grad_()
        out = depthwise_conv3d(x, w, torch.from_numpy(idx),
                               torch.from_numpy(count),
                               torch.from_numpy(bins), window=window)
        assert out.dtype == tdt
        out.backward(torch.from_numpy(cot).to(tdt))
        return _f32(out), _f32(x.grad), _f32(w.grad)

    ref32, got32 = jax_run(jnp.float32), port_run(torch.float32)
    for got, ref in zip(got32, ref32):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref16, got16 = jax_run(jnp.bfloat16), port_run(torch.bfloat16)
    np.testing.assert_allclose(got16[0], ref16[0], rtol=2e-2, atol=2e-2)
    for i in (1, 2):
        assert _rel(got16[i], ref32[i]) <= max(_rel(ref16[i], ref32[i]),
                                               2.0 ** -8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [128, None])
def test_max_pool_matches_jax(window, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, n, c, m, k = 2, 300, 6, 140, 8
    feats = rng.integers(-3, 4, (b, n, c)).astype(np.float32)
    idx, count = local_edges(rng, b, n, m, k, spread=30)
    cot = rng.integers(-4, 5, (b, m, c)).astype(np.float32)

    ref, vjp = jax.vjp(
        lambda x: j_max_pool(x, jnp.asarray(idx), jnp.asarray(count),
                             window=window)[0], jnp.asarray(feats, jdt))
    _, ref_arg = j_max_pool(jnp.asarray(feats, jdt), jnp.asarray(idx),
                            jnp.asarray(count), window=window)
    (ref_dx,) = vjp(jnp.asarray(cot, jdt))

    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    got, got_arg = max_pool3d(x, torch.from_numpy(idx),
                              torch.from_numpy(count), window=window)
    got.backward(torch.from_numpy(cot).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(ref))
    np.testing.assert_array_equal(got_arg.numpy(), np.asarray(ref_arg))
    np.testing.assert_array_equal(_f32(x.grad), _f32(ref_dx))
    # ties are real: some row has a tied maximum
    g = feats[np.arange(b)[:, None, None], idx]
    assert (np.sum(g == g.max(axis=2, keepdims=True), axis=2) > 1).any()


def test_sphere_query_and_bins_match_jax(monkeypatch):
    """Several query tiles (the byte budget cut to 40 query rows), kernel
    (8, 2, 2), K = 24 (rows with more in-range points keep the first 24);
    bins also equal ``spherical_kernel``'s."""
    rng = np.random.default_rng(6)
    b, n = 2, 600
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    xyz = v * rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    monkeypatch.setattr(tn, "_TILE_BYTES", 4 * b * n * 40)
    assert tn._query_tile_size(b, n, n) == 40
    jn, jb = j_query_bins(jnp.asarray(xyz), jnp.asarray(xyz), 0.2, 24,
                          (8, 2, 2), self_graph=True)
    t = torch.from_numpy(xyz)
    nbh, bins = tn.build_sphere_neighbor_and_bins(t, t, 0.2, 24, (8, 2, 2))
    np.testing.assert_array_equal(nbh.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(nbh.count.numpy(), np.asarray(jn.count))
    np.testing.assert_allclose(nbh.dist.numpy(), np.asarray(jn.dist),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        bins.numpy(), spherical_kernel(t, t, nbh, 0.2, (8, 2, 2)).numpy())
    assert int(nbh.count.max()) == 24 and int(nbh.count.min()) >= 1
    assert len(np.unique(bins.numpy())) == 33


# ------------------------------------------------- the whole ModelNet model

# The windowed engine at the test size of test_torch_modelnet.py (B=2,
# N=1024, num_sample (256, 64, 16), the published channels, K = 64,
# kernel (8, 2, 2)) with conv windows 512/256/128 on axis-sorted clouds,
# and the f32 parity config (no windows, no sort). The JAX model's
# variables (numpy-seeded) load into the port through utils.convert:
# parameter trees are the same on both engines. Logits: f32 rtol=atol=1e-4,
# bf16 5e-2 with equal argmax (test_torch_modelnet.py's reasons). The train
# step: test_torch_train.py's STEP_TOL and its bf16 rule (each gradient
# leaf's error against the f32 gradients at most 1.5x JAX's own bf16 error
# plus 0.02).

MODEL_CASES = {"f32": ("float32", (512, 256, 128)),
               "bf16": ("bfloat16", (512, 256, 128)),
               "f32_parity": ("float32", None)}


def _windowed_config(case, factory=modelnet_config):
    dtype, windows = MODEL_CASES[case]
    return dataclasses.replace(
        factory(), num_input=N, num_sample=(256, 64, 16), windows=windows,
        spatial_sort=windows is not None, compute_dtype=dtype,
    )


def _port_model(case, variables):
    model = SPH3DModelNet(_windowed_config(case))
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict()))
    return model


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_windowed_model_logits_match_jax(variables, case):
    jcfg = _windowed_config(case, jax_modelnet_config)
    pts = _points()
    ref = np.asarray(jax.jit(lambda v, p: JaxModelNet(jcfg).apply(v, p))(
        variables, pts))
    model = _port_model(case, variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    assert not model.config.dense_graph and bool(model.dense_ok)
    assert got.dtype == torch.float32 and got.shape == (B, 40)
    assert np.abs(ref).max() > 0.1
    tol = 5e-2 if case == "bf16" else 1e-4
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


@functools.lru_cache(maxsize=None)
def _jax_windowed_step(case):
    """JAX's (loss, data loss, logits, new stats, grads) of one windowed
    train step with dropout intercepted, on the numpy-seeded variables."""
    pts = _points()
    variables = _flax_variables(pts)
    jcfg = _windowed_config(case, jax_modelnet_config)
    sf = jax_step_factory(JaxModelNet(jcfg), optax.adam(1e-3),
                          weight_decay=jcfg.weight_decay)
    batch = {"points": jnp.asarray(pts), "label": jnp.asarray(LABELS)}

    def losses(params, stats):
        return sf._losses(params, stats, batch, jax.random.key(0), True)

    with fnn.intercept_methods(_no_dropout):
        (total, (data_loss, logits, new_stats, _, _)), grads = jax.jit(
            jax.value_and_grad(losses, has_aux=True)
        )(variables["params"], variables["batch_stats"])
    return total, data_loss, logits, new_stats, dict(_leaves(grads))


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_windowed_train_step_matches_jax(variables, case):
    tol = STEP_TOL[MODEL_CASES[case][0]]
    total, data_loss, logits, new_stats, ref = _jax_windowed_step(case)
    model = _port_model(case, variables)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    opt, sch = make_optimizer(model.parameters(), "adam", 1e-3)
    step = classification_step_factory(model, opt, sch,
                                       weight_decay=model.config.weight_decay)
    with _build.record_calls() as calls:
        metrics = step.loss_and_grads({"points": torch.from_numpy(_points()),
                                       "label": torch.from_numpy(LABELS)})
    names = [name for name, _, _ in calls]
    assert names.count("window_gather") == 9
    assert names.count("window_gather_bwd") == 9
    assert bool(metrics["dense_ok"])
    assert _rel(metrics["loss"], total) < tol["loss"]
    assert _rel(metrics["data_loss"], data_loss) < tol["loss"]
    assert _rel(metrics["logits"], logits) < tol["logits"]
    ours = dict(_leaves(flax_tree_from_torch(
        {k: p.grad for k, p in model.named_parameters()})["params"]))
    assert set(ours) == set(ref)
    if case == "f32":
        bound = {k: tol["grad"] for k in ref}
        errs = {k: _rel(ours[k], ref[k]) for k in ref}
    else:
        f32 = _jax_windowed_step("f32")[-1]
        bound = {k: 1.5 * _rel(ref[k], f32[k]) + 0.02 for k in ref}
        errs = {k: _rel(ours[k], f32[k]) for k in ref}
    bad = {k: (errs[k], bound[k]) for k in ref if not errs[k] < bound[k]}
    assert not bad, bad
    stats = dict(_leaves(flax_tree_from_torch(
        {k: v for k, v in model.state_dict().items()
         if k.endswith((".mean", ".var"))})["batch_stats"]))
    ref_stats = dict(_leaves(new_stats))
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], np.asarray(ref_stats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])


def test_fallback_logits_match_jax():
    """What ``checked_forward`` returns for a batch whose dense
    certificate fails (the per-edge engine's logits) equals what the JAX
    package's fallback computes: its classic engine on the same weights
    (bf16: rtol=atol=5e-2, equal argmax)."""
    model, pts = fallback_case()
    got = checked_forward(model, "cpu")(pts)
    assert not bool(model.dense_ok)
    jcfg = dataclasses.replace(jax_modelnet_config(num_input=512, fast=True),
                               windows=(128,))
    ref = np.asarray(JaxModelNet(jcfg).apply(
        flax_tree_from_torch(model.state_dict()), pts))
    np.testing.assert_allclose(got, ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
