"""PyTorch port vs JAX package: the port's own ModelNet, S3DIS and ScanNet
configs, vote augmentation and synthetic clouds and scene blocks equal
the JAX package's (exactly)."""

import dataclasses

import numpy as np
import pytest

import bench
from sph3d_gcn_tpu.configs import SPH3DConfig as JaxConfig
from sph3d_gcn_tpu import configs as jax_configs
from sph3d_gcn_tpu.configs import modelnet_config as jax_modelnet_config
from sph3d_gcn_tpu.train import eval as jax_eval
from sph3d_gcn_torch import configs
from sph3d_gcn_torch.configs import SPH3DConfig, modelnet_config
from sph3d_gcn_torch.data.synthetic import scene_blocks, surface_clouds
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
    assert_same_config(modelnet_config(**kw), jax_modelnet_config(**kw))


def assert_same_config(got, ref):
    fields = [f.name for f in dataclasses.fields(SPH3DConfig)]
    assert set(fields) <= {f.name for f in dataclasses.fields(JaxConfig)}
    for name in fields:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.bin_size == ref.bin_size
    for level in range(len(got.num_sample)):
        assert got.enc_window(level) == ref.enc_window(level)
        assert got.pool_window(level) == ref.pool_window(level)
        assert got.dec_window(level) == ref.dec_window(level)


@pytest.mark.parametrize("name", ["s3dis_config", "scannet_config"])
@pytest.mark.parametrize("kw", [
    {},
    {"fast": True, "dense": True},
    {"num_input": 1024, "fast": True, "dense": True},
    {"num_input": 2048, "fast": True},
])
def test_scene_seg_configs_match_jax(name, kw):
    assert_same_config(getattr(configs, name)(**kw),
                       getattr(jax_configs, name)(**kw))


def test_dec_window_fallback_matches_jax():
    # without calibrated decoder windows both scale the encoder windows
    for factory, jfactory in ((configs.s3dis_config, jax_configs.s3dis_config),
                              (modelnet_config, jax_modelnet_config)):
        got = dataclasses.replace(factory(fast=True), dec_windows=None)
        ref = dataclasses.replace(jfactory(fast=True), dec_windows=None)
        assert [got.dec_window(i) for i in range(len(got.num_sample))] == [
            ref.dec_window(i) for i in range(len(ref.num_sample))]


@pytest.mark.parametrize("bad", [
    {"dense_graph": True, "windows": None},
    {"windows": (512,)},
    {"radius": (0.1,)},
    {"kernel": (8, 0, 2)},
    {"sample": "grid"},
    {"dec_windows": (128,)},
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


def test_scene_blocks_match_the_benchmark_generator():
    got = scene_blocks(np.random.default_rng(7), 2, 300)
    ref = bench.scene_blocks(np.random.default_rng(7), 2, 300)
    assert got.dtype == np.float32 and got.shape == (2, 300, 9)
    np.testing.assert_array_equal(got, ref)
