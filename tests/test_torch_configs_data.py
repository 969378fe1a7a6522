"""PyTorch port vs JAX package: the port's own ModelNet config, vote
augmentation and synthetic clouds equal the JAX package's (exactly)."""

import dataclasses

import numpy as np
import pytest

import bench
from sph3d_gcn_tpu.configs import SPH3DConfig as JaxConfig
from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.train import eval as jax_eval
from sph3d_gcn_torch.configs import SPH3DConfig, modelnet_config
from sph3d_gcn_torch.data.synthetic import surface_clouds
from sph3d_gcn_torch.train import eval as torch_eval


@pytest.mark.parametrize("kw", [
    {},
    {"fast": True},
    {"fast": True, "dense": True},
    {"fast": True, "dense": True, "family": "hard"},
    {"num_input": 1024, "fast": True, "dense": True},
    {"num_input": 2048, "fast": True, "dense": True, "family": "hard"},
])
def test_modelnet_config_matches_jax(kw):
    got, ref = modelnet_config(**kw), jax_modelnet_config(**kw)
    fields = [f.name for f in dataclasses.fields(SPH3DConfig)]
    assert set(fields) <= {f.name for f in dataclasses.fields(JaxConfig)}
    for name in fields:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.bin_size == ref.bin_size
    for level in range(len(got.num_sample)):
        assert got.enc_window(level) == ref.enc_window(level)
        assert got.pool_window(level) == ref.pool_window(level)


@pytest.mark.parametrize("bad", [
    {"dense_graph": True, "windows": None},
    {"windows": (512,)},
    {"radius": (0.1,)},
    {"kernel": (8, 0, 2)},
    {"sample": "grid"},
])
def test_config_validation_matches_jax(bad):
    for factory in (modelnet_config, jax_modelnet_config):
        with pytest.raises(ValueError):
            dataclasses.replace(factory(fast=True, dense=True), **bad)


def test_vote_classify_sees_the_jax_votes():
    batch = surface_clouds(np.random.default_rng(0), 3, 200)
    seen = {"jax": [], "torch": []}

    def forward(key):
        def fn(x):
            seen[key].append(np.array(x))
            return x.sum(axis=1)[:, :2]
        return fn

    ref = jax_eval.vote_classify(forward("jax"), batch, num_votes=4,
                                 rng=np.random.default_rng(5))
    got = torch_eval.vote_classify(forward("torch"), batch, num_votes=4,
                                   rng=np.random.default_rng(5))
    np.testing.assert_array_equal(got, ref)
    assert len(seen["torch"]) == 4
    for a, b in zip(seen["torch"], seen["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(seen["torch"][1], batch)


def test_surface_clouds_match_the_benchmark_generator():
    got = surface_clouds(np.random.default_rng(7), 2, 500)
    ref = bench.surface_clouds(np.random.default_rng(7), 2, 500)
    assert got.dtype == np.float32 and got.shape == (2, 500, 3)
    np.testing.assert_array_equal(got, ref)
