"""PyTorch port vs JAX: the whole ModelNet serving forward.

A 3-level dense-mode ``SPH3DConfig`` at the published channels, kernel
(8, 2, 2) and K = 64, cut to B=2, N=1024, num_sample=(256, 64, 16) — so
level 2's first conv still sees C_in = 131. Numpy-seeded weights in the
Flax tree layout go through the JAX model and, carried across by
``sph3d_gcn_torch.utils.convert``, through the port.

Tolerances: f32 logits rtol=atol=1e-4 (f32 sums in other orders through
12 layers); bf16 logits rtol=atol=5e-2 with equal argmax (bf16 rounding
points differ slightly between the two conv formulations).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.models import SPH3DModelNet as JaxModelNet
from sph3d_gcn_torch.configs import modelnet_config
from sph3d_gcn_torch.models import SPH3DModelNet
from sph3d_gcn_torch.utils.convert import torch_state_dict_from_flax

B, N = 2, 1024


def _config(dtype, factory=modelnet_config):
    """The test config from the port's (default) or the JAX package's
    ``modelnet_config``."""
    return dataclasses.replace(
        factory(), num_input=N, num_sample=(256, 64, 16),
        windows=(512, 256, 128), dense_graph=True, spatial_sort=True,
        compute_dtype=dtype,
    )


def _points():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((B, N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rng.uniform(0.3, 1.0, (B, 1, 3)).astype(np.float32)


def _flax_variables(pts):
    """The JAX model's variable tree (shapes from tracing init), filled
    with numpy-seeded values: He-scaled weights, BN terms near 1 / 0."""
    shapes = jax.eval_shape(
        lambda p: JaxModelNet(_config("float32", jax_modelnet_config)).init(
            jax.random.key(0), p), pts
    )
    rng = np.random.default_rng(1)

    def fill(path, s):
        name = path[-1].key
        if name in ("weights", "depthwise_weights"):
            fan = s.shape[-2] * int(np.prod(s.shape[:-2]))
            return rng.standard_normal(s.shape).astype(np.float32) * np.float32(
                np.sqrt(2.0 / fan))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def variables():
    return _flax_variables(_points())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_modelnet_logits_match_jax(variables, dtype, tol):
    cfg = _config(dtype)
    jcfg = _config(dtype, jax_modelnet_config)
    pts = _points()
    ref, inter = jax.jit(
        lambda v, p: JaxModelNet(jcfg).apply(v, p, mutable=["intermediates"])
    )(variables, pts)
    (ref_ok,) = inter["intermediates"]["dense_ok"]

    model = SPH3DModelNet(cfg).eval()
    model.load_state_dict(
        torch_state_dict_from_flax(variables, model.state_dict())
    )
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    assert got.dtype == torch.float32 and got.shape == (B, 40)
    assert bool(model.dense_ok) == bool(ref_ok)
    assert bool(model.dense_ok)
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0.1          # logits are not vanishing
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), ref.argmax(-1))


def test_converter_rejects_unused_and_missing(variables):
    model = SPH3DModelNet(_config("float32"))
    sd = model.state_dict()
    params = dict(variables["params"])
    params["extra"] = {"weights": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        torch_state_dict_from_flax(
            {"params": params, "batch_stats": variables["batch_stats"]}, sd)
    with pytest.raises(ValueError, match="conv1._1.bn.mean"):
        torch_state_dict_from_flax({"params": variables["params"]}, sd)
    bad = {k: dict(v) for k, v in variables["params"].items()}
    bad["fc1"]["weights"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        torch_state_dict_from_flax(
            {"params": bad, "batch_stats": variables["batch_stats"]}, sd)


def test_unported_configs_raise():
    # the classic (per-edge) engine is ported: it builds and runs
    classic = SPH3DModelNet(modelnet_config(num_input=N),
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = classic.eval()(torch.from_numpy(_points()))
    assert out.shape == (B, 40) and torch.isfinite(out).all()
    assert bool(classic.dense_ok)
    # every sampler and pool of the config is ported
    # (tests/test_torch_sampling_options.py); an unknown one is refused
    for ported in ({"sample": "IDS"}, {"sample": "random"},
                   {"pool_method": "avg"}):
        SPH3DModelNet(dataclasses.replace(_config("float32"), **ported))
    with pytest.raises(ValueError, match="sampling"):
        dataclasses.replace(_config("float32"), sample="bogus")
    model = SPH3DModelNet(_config("float32"))
    with pytest.raises(ValueError):
        model(torch.zeros(1, 512, 3))
    # train mode runs (batch-statistics BN, dropout) and updates BN stats
    before = model.conv1._1.bn.mean.clone()
    logits = model.train()(torch.from_numpy(_points()),
                           generator=torch.Generator().manual_seed(0))
    assert logits.shape == (B, 40) and torch.isfinite(logits).all()
    assert not torch.equal(model.conv1._1.bn.mean, before)
