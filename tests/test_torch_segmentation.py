"""PyTorch port vs JAX: the whole S3DIS scene-segmentation forward, its
losses and the coverage-vote eval protocol.

``s3dis_config(fast=True, dense=True)`` at its published channels (mlp
64, levels 128/256/256/512, r=2, kernel (8, 2, 2), K=64), cut to B=2,
N=1024 (levels 1024 -> 256 -> 96 -> 48 -> 16) with the small-size windows
the JAX package's own sharded-step test uses (``tests/test_spatial.py``:
the 8192-point calibration does not cover 1024 points), so the decoder's
second block still sees C_in = 1024 and its inter graphs grow their
radius. Numpy-seeded weights in the Flax tree layout go through the JAX
model and, carried across by ``sph3d_gcn_torch.utils.convert``, through
the port.

Tolerances: f32 logits rtol=atol=1e-4 (f32 sums in other orders through
18 layers); bf16 logits rtol=atol=5e-2 with equal argmax (bf16 rounding
points differ slightly between the two conv formulations: the JAX
kernel for C_in > 128 rounds after its f32 scale, the port's once at its
output).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.configs import s3dis_config as jax_s3dis_config
from sph3d_gcn_tpu.models import SPH3DSceneSeg as JaxSceneSeg
from sph3d_gcn_tpu.models import segmentation as jseg
from sph3d_gcn_tpu.train import eval as jax_eval
from sph3d_gcn_torch import _build
from sph3d_gcn_torch.configs import s3dis_config
from sph3d_gcn_torch.data.synthetic import scene_blocks
from sph3d_gcn_torch.models import SPH3DSceneSeg
from sph3d_gcn_torch.models import segmentation as tseg
from sph3d_gcn_torch.ops import query as Q
from sph3d_gcn_torch.train import eval as torch_eval
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax

B, N = 2, 1024


def _config(dtype, factory=s3dis_config):
    return dataclasses.replace(
        factory(num_input=N, fast=True, dense=True),
        windows=(768, 512, 256, 128), dec_windows=(512,) * 4,
        growth_steps=12, dec_margin=384, compute_dtype=dtype,
    )


def _points():
    return scene_blocks(np.random.default_rng(3), B, N)


def _flax_variables(pts):
    """The JAX model's variable tree (shapes from tracing init), filled
    with numpy-seeded values: He-scaled weights, BN terms near 1 / 0."""
    shapes = jax.eval_shape(
        lambda p: JaxSceneSeg(_config("float32", jax_s3dis_config)).init(
            jax.random.key(0), p), pts
    )
    rng = np.random.default_rng(1)

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


@pytest.fixture(scope="module")
def variables():
    return _flax_variables(_points())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_scene_seg_logits_match_jax(variables, dtype, tol):
    cfg = _config(dtype)
    jcfg = _config(dtype, jax_s3dis_config)
    pts = _points()
    ref, inter = jax.jit(
        lambda v, p: JaxSceneSeg(jcfg).apply(v, p, mutable=["intermediates"])
    )(variables, pts)
    (ref_ok,) = jax.tree_util.tree_leaves(inter["intermediates"])

    model = SPH3DSceneSeg(cfg).eval()
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict())
    )
    with _build.record_calls() as calls, torch.no_grad():
        got = model(torch.from_numpy(pts))
    assert got.dtype == torch.float32 and got.shape == (B, N, 13)
    assert bool(model.dense_ok) and bool(ref_ok)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1          # logits are not vanishing
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))
    # the decoders' inter graphs grew the radius of some rows
    grown = [Q.growth_query_plain(*args, **kw)[1] for name, args, kw in calls
             if name == "growth_query"]
    assert len(grown) == 4
    assert max(int(s.max()) for s in grown) > 0
    # every conv width of the path, the decoder's C_in = 1024 included
    widths = sorted({args[2].shape[-1] for name, args, _ in calls
                     if name == "dense_conv"})
    assert widths == [64, 128, 256, 512, 1024]


def test_converter_rejects_unused_and_missing(variables):
    model = SPH3DSceneSeg(_config("float32"))
    sd = model.state_dict()
    params = dict(variables["params"])
    params["extra"] = {"weights": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        torch_state_dict_from_flax(
            {"params": params, "batch_stats": variables["batch_stats"]}, sd)
    with pytest.raises(ValueError, match="backbone.deconv2._1.bn.mean"):
        torch_state_dict_from_flax({"params": variables["params"]}, sd)
    bad = {k: dict(v) for k, v in variables["params"].items()}
    bad["logits"]["weights"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        torch_state_dict_from_flax(
            {"params": bad, "batch_stats": variables["batch_stats"]}, sd)


def test_segmentation_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 50, 13)).astype(np.float32) * 3
    labels = rng.integers(0, 13, (3, 50)).astype(np.int32)
    inner = rng.integers(0, 2, (3, 50)).astype(np.int32)
    inner[1] = 0                          # an item with no inner point
    t = [torch.from_numpy(a) for a in (logits, labels, inner)]
    for tf, jf, args in (
        (tseg.segmentation_item_loss, jseg.segmentation_item_loss, 2),
        (tseg.segmentation_loss, jseg.segmentation_loss, 2),
        (tseg.inner_masked_item_loss, jseg.inner_masked_item_loss, 3),
        (tseg.inner_masked_segmentation_loss,
         jseg.inner_masked_segmentation_loss, 3),
    ):
        got = tf(*t[:args]).numpy()
        ref = np.asarray(jf(*(logits, labels, inner)[:args]))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert tseg.inner_masked_item_loss(*t)[1] == 0


# (N, B): blocks below and above N; partial last batches padded or not
@pytest.mark.parametrize("n_model,batch", [(48, 2), (64, 3), (30, 5)])
def test_coverage_eval_blocks_matches_jax(n_model, batch):
    rng = np.random.default_rng(5)
    blocks = []
    for p in (40, 70, 25, 55, 90):        # fewer and more points than N
        pts = rng.standard_normal((p, 9)).astype(np.float32)
        inner = (rng.uniform(size=p) < 0.4).astype(np.int32)
        blocks.append((pts, inner))
    seen = {"jax": [], "torch": []}

    def forward(key):
        def fn(x, ids):
            seen[key].append((np.array(x), list(ids)))
            return np.concatenate([x[..., :3] * 2, x[..., 3:5] ** 2], -1)
        return fn

    ref = jax_eval.coverage_eval_blocks(
        forward("jax"), blocks, n_model, batch, rng=np.random.default_rng(6))
    got = torch_eval.coverage_eval_blocks(
        forward("torch"), blocks, n_model, batch,
        rng=np.random.default_rng(6))
    assert len(got) == len(ref) == 5
    for g, r, (pts, inner) in zip(got, ref, blocks):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
        assert (np.abs(g[inner == 1]).sum(-1) > 0).all()  # inner covered
    assert len(seen["torch"]) == len(seen["jax"]) > 1
    for (a, ia), (b, ib) in zip(seen["torch"], seen["jax"]):
        assert a.shape == (batch, n_model, 9)
        np.testing.assert_array_equal(a, b)
        assert ia == ib


def test_unported_options_raise():
    # the weighted unpool, IDS / random sampling and the avg pool are
    # ported (tests/test_torch_sampling_options.py), and so is the
    # per-edge engine (tests/test_torch_seg_per_edge.py): each builds,
    # and the per-edge model serves a batch
    cfg = _config("float32")
    model = SPH3DSceneSeg(dataclasses.replace(cfg, dense_graph=False),
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(_points()[:1]))
    assert out.shape == (1, N, 13) and bool(torch.isfinite(out).all())
    assert bool(model.dense_ok)
    for ported in ({"unpool_method": "weighted"}, {"sample": "IDS"},
                   {"pool_method": "avg"}):
        SPH3DSceneSeg(dataclasses.replace(cfg, **ported))
    with pytest.raises(ValueError):
        SPH3DSceneSeg(cfg)(torch.zeros(1, 512, 9))
