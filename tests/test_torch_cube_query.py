"""PyTorch port vs JAX: the cube query, ``dilation_rate`` and the config
field ``nnsearch``.

- ``ops.build_cube_neighbor`` against JAX's ``build_cube_neighbor`` and
  the loop oracle ``sph3d_gcn_tpu.ops._ref.cube_neighbor``: idx, bin and
  count exactly (padding 0 in all three), on JAX's cases of
  ``tests/test_ops_neighbor.py`` and with ``nn_sample`` at least the
  in-cube count; the query tiled over a small budget equal to the
  untiled query; ``dilation_rate`` on the cube's edge.
- ``dilation_rate`` on ``build_sphere_neighbor`` and
  ``build_sphere_neighbor_and_bins`` against JAX: idx, count and bins
  exactly, the sqrt-space distances within one ulp per square root (the
  CPU's ``torch.sqrt`` is not always correctly rounded,
  ``tests/test_torch_query.py``); a dilated query equal to an undilated
  one at the product radius.
- ``nnsearch``: the port's configs hold JAX's value, a config with
  ``nnsearch="cube"`` crosses to JAX and back, and a JAX snapshot with
  it loads through ``load_config_snapshot``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu import configs as jax_configs
from sph3d_gcn_tpu.ops import _ref
from sph3d_gcn_tpu.ops.neighbor import build_cube_neighbor as j_cube
from sph3d_gcn_tpu.ops.neighbor import build_sphere_neighbor as j_sphere
from sph3d_gcn_tpu.ops.neighbor import (
    build_sphere_neighbor_and_bins as j_sphere_bins,
)
from sph3d_gcn_tpu.train.checkpoint import load_config_snapshot as jax_load
from sph3d_gcn_tpu.train.checkpoint import snapshot_config as jax_snapshot
from sph3d_gcn_torch import configs, ops
from sph3d_gcn_torch.ops import neighbor as N
from sph3d_gcn_torch.train.checkpoint import (
    load_config_snapshot,
    snapshot_config,
)
from test_torch_cli import one_torch_thread  # noqa: F401
from test_torch_configs_data import assert_same_config


def _random_cloud(rng, b, n, scale=1.0):
    """``tests/test_ops_neighbor.py``'s clouds."""
    return (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)


def _cube_case(seed=3, n=48, m=16):
    rng = np.random.default_rng(seed)
    return _random_cloud(rng, 2, n), _random_cloud(rng, 2, m)


def _assert_cube(got, idx, bins, count):
    assert got.idx.dtype == got.bin.dtype == got.count.dtype == torch.int64
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got.bin.numpy(), np.asarray(bins))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(count))


# JAX's cases, then budgets at least the in-cube count (48 points: every
# row keeps all its points, and K = 64 runs past the cloud)
@pytest.mark.parametrize("length,gridsize,k", [
    (0.6, 3, 8), (1.0, 2, 4), (1.0, 3, 48), (2.5, 3, 64)])
def test_cube_matches_jax_and_loop_oracle(length, gridsize, k):
    db, q = _cube_case()
    got = ops.build_cube_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                                  length=length, nn_sample=k,
                                  gridsize=gridsize)
    jn = j_cube(jnp.asarray(db), jnp.asarray(q), length=length, nn_sample=k,
                gridsize=gridsize)
    _assert_cube(got, jn.idx, jn.bin, jn.count)
    _assert_cube(got, *_ref.cube_neighbor(db, q, length, k, gridsize))
    counts = got.count.numpy()
    assert counts.max() > 0 and len(np.unique(got.bin.numpy())) > 2
    if k >= 48:
        # every row keeps its whole cube: the count is the in-cube total
        inside = (np.abs(db[:, None] - q[:, :, None]) < length / 2).all(-1)
        np.testing.assert_array_equal(counts, inside.sum(-1))


def test_cube_dilation_matches_jax():
    db, q = _cube_case(seed=5)
    got = ops.build_cube_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                                  length=0.4, nn_sample=8, gridsize=3,
                                  dilation_rate=1.5)
    jn = j_cube(jnp.asarray(db), jnp.asarray(q), length=0.4, nn_sample=8,
                gridsize=3, dilation_rate=1.5)
    _assert_cube(got, jn.idx, jn.bin, jn.count)
    # the edge 1.5 * 0.4 as a Python float product
    _assert_cube(got, *_ref.cube_neighbor(db, q, 1.5 * 0.4, 8, 3))


def test_cube_tiles_equal_one_block(monkeypatch):
    db, q = _cube_case(seed=7, n=300, m=45)
    db_t, q_t = torch.from_numpy(db), torch.from_numpy(q)
    whole = ops.build_cube_neighbor(db_t, q_t, length=0.8, nn_sample=12)
    # 7 queries a tile: 7 tiles, the last one short
    monkeypatch.setattr(N, "_PLAIN_BUDGET", 7 * 3 * 2 * 300)
    tiled = ops.build_cube_neighbor(db_t, q_t, length=0.8, nn_sample=12)
    for a, b in zip(tiled, whole):
        assert torch.equal(a, b)
    assert int(whole.count.max()) == 12


def _sphere_case(seed=4):
    rng = np.random.default_rng(seed)
    return _random_cloud(rng, 2, 96, 0.5), _random_cloud(rng, 2, 24, 0.5)


def _assert_dist(got, ref):
    """Sqrt-space distances: two square roots, one ulp each."""
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref), maxulp=2)


@pytest.mark.parametrize("self_graph", [False, True])
@pytest.mark.parametrize("rate", [2.0, 1.5])
def test_sphere_dilation_matches_jax(rate, self_graph):
    db, q = _sphere_case()
    if self_graph:
        q = db
    # far queries grow their dilated radius (never on a self graph)
    q = q.copy()
    q[:, :2] += np.float32(0 if self_graph else 4.0)
    db_t, q_t = torch.from_numpy(db), torch.from_numpy(q)
    kw = dict(radius=0.35, nn_sample=10, dilation_rate=rate,
              self_graph=self_graph)
    got = ops.build_sphere_neighbor(db_t, q_t, **kw)
    jn = j_sphere(jnp.asarray(db), jnp.asarray(q), **kw)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(jn.count))
    _assert_dist(got.dist, jn.dist)
    assert int(got.count.min()) > 0 and int(got.count.max()) == 10

    nbh, bins = N.build_sphere_neighbor_and_bins(db_t, q_t, kernel=(8, 2, 2),
                                                 **kw)
    jnb, jbins = j_sphere_bins(jnp.asarray(db), jnp.asarray(q),
                               kernel=(8, 2, 2), **kw)
    np.testing.assert_array_equal(nbh.idx.numpy(), np.asarray(jnb.idx))
    np.testing.assert_array_equal(nbh.count.numpy(), np.asarray(jnb.count))
    _assert_dist(nbh.dist, jnb.dist)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    # both radial bins (split at half the dilated radius) are served
    assert set(np.unique(bins.numpy()) // 17) >= {0, 1}

    # the same query at the product radius, bit for bit
    plain = dict(kw, radius=rate * 0.35, dilation_rate=None)
    nbh2, bins2 = N.build_sphere_neighbor_and_bins(db_t, q_t,
                                                   kernel=(8, 2, 2), **plain)
    for a, b in zip(nbh + (bins,), nbh2 + (bins2,)):
        assert torch.equal(a, b)


def test_nnsearch_field_matches_jax(tmp_path):
    cfg = configs.modelnet_config()
    assert cfg.nnsearch == jax_configs.modelnet_config().nnsearch == "sphere"
    cube = dataclasses.replace(cfg, nnsearch="cube")
    assert_same_config(cube, dataclasses.replace(
        jax_configs.modelnet_config(), nnsearch="cube"))
    # the port's snapshot loads in JAX with the field, and back
    snapshot_config(tmp_path, cube)
    assert jax_load(tmp_path).nnsearch == "cube"
    assert load_config_snapshot(tmp_path) == cube


@pytest.mark.parametrize("make", [
    lambda m: m.modelnet_config(),
    lambda m: m.s3dis_config(fast=True, dense=True),
])
def test_jax_snapshot_with_cube_search_loads(make, tmp_path):
    theirs = dataclasses.replace(make(jax_configs), nnsearch="cube")
    jax_snapshot(tmp_path, theirs)
    ours = load_config_snapshot(tmp_path)
    assert ours.nnsearch == "cube"
    assert_same_config(ours, theirs)
    assert ours == dataclasses.replace(make(configs), nnsearch="cube")
