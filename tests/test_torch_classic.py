"""PyTorch port vs JAX: the classic ops of ModelNet's global conv — the
sphere query (without radius growth), spherical kernel bins and the
plain-gather depthwise conv (ids exact, f32 values rtol=atol=1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.nn.graph import build_global_graph as j_global
from sph3d_gcn_tpu.ops.conv import depthwise_conv3d as j_conv
from sph3d_gcn_tpu.ops.kernelbin import spherical_kernel as j_bins
from sph3d_gcn_tpu.ops.neighbor import build_sphere_neighbor as j_sphere
from sph3d_gcn_torch.nn.graph import build_global_graph
from sph3d_gcn_torch.ops.conv import depthwise_conv3d
from sph3d_gcn_torch.ops.kernelbin import spherical_kernel
from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor


def _cloud(seed, b=2, n=156):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v * rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)


def _assert_nbh(got, ref):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(ref.dist),
                               rtol=1e-5, atol=1e-5)


def test_global_graph_bins_and_conv():
    xyz = _cloud(0)
    query = xyz.mean(axis=1, keepdims=True)
    jn = j_global(jnp.asarray(xyz), jnp.asarray(query), 100.0)
    tn = build_global_graph(torch.from_numpy(xyz), torch.from_numpy(query),
                            100.0)
    _assert_nbh(tn, jn)
    jb = j_bins(jnp.asarray(xyz), jnp.asarray(query), jn, 100.0, (8, 2, 1))
    tb = spherical_kernel(torch.from_numpy(xyz), torch.from_numpy(query), tn,
                          100.0, (8, 2, 1))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert len(np.unique(tb.numpy())) > 8

    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 156, 128)).astype(np.float32)
    filt = rng.standard_normal((17, 128, 2)).astype(np.float32)
    ref = j_conv(jnp.asarray(feats), jnp.asarray(filt), jn.idx, jn.count, jb)
    got = depthwise_conv3d(torch.from_numpy(feats), torch.from_numpy(filt),
                           tn.idx, tn.count, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("offset", [0.0, 0.3])
def test_sphere_query_first_k(offset):
    """First K in point order, without radius growth: the JAX op's
    ``self_graph=True`` form (queries off the cloud, ``offset`` 0.3, leave
    some with no neighbor and count 0)."""
    db = _cloud(2, n=300)
    q = db[:, ::5] + np.float32(offset)
    jn = j_sphere(jnp.asarray(db), jnp.asarray(q), radius=0.25, nn_sample=12,
                  self_graph=True)
    tn = build_sphere_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                               radius=0.25, nn_sample=12, self_graph=True)
    _assert_nbh(tn, jn)
    assert int(tn.count.max()) == 12
    assert (int(tn.count.min()) == 0) == (offset > 0)
    bins_j = j_bins(jnp.asarray(db), jnp.asarray(q), jn, 0.25, (8, 2, 3))
    bins_t = spherical_kernel(torch.from_numpy(db), torch.from_numpy(q), tn,
                              0.25, (8, 2, 3))
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j))


def test_zero_neighbor_queries_keep_count_zero():
    db = _cloud(3, n=100)
    q = np.full((2, 3, 3), 2.0, np.float32)    # far from every point
    jn = j_sphere(jnp.asarray(db), jnp.asarray(q), radius=0.1, nn_sample=4,
                  self_graph=True)
    tn = build_sphere_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                               radius=0.1, nn_sample=4, self_graph=True)
    _assert_nbh(tn, jn)
    assert (tn.count == 0).all() and (tn.idx == 0).all()
