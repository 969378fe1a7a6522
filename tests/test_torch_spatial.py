"""PyTorch port vs JAX: point-axis sharding's primitives, and the dense
ops on point-sharded operands.

Four gloo ranks on the CPU, started once for the file
(``parallel.RankPool``; the rank functions are in
``torch_spatial_workers.py``), form one point group. JAX's side runs
``sph3d_gcn_tpu.parallel.spatial`` under ``shard_map`` over four of the
conftest's virtual CPU devices, as ``tests/test_spatial.py`` does.

- ``halo_exchange`` at (halo, n_local) (2, 4), (5, 4) and (8, 2) (multi-
  hop halos, and one wider than the other ranks hold) against numpy's
  padded slices and JAX's, bitwise; ``halo_reduce`` against JAX's
  (f32 sums of the same terms, in JAX's order: bitwise) and as the
  exchange's transpose; the gradient through each is the other, bitwise.
- ``all_rows`` and ``psum_replicated``: a replicated loss of the
  gathered rows, seeded 1/R on each rank, has the true value and each
  rank the true gradient of its rows (rtol 1e-6: f32 sums of 4 terms).
- The conv, the max pool and the weighted unpool on each rank's query
  tiles with haloed rows (``localize_tiles``) against the unsharded op,
  and the sharded query build (``query_shard``) equal to the unsharded
  graph's tiles, at ``test_spatial.py``'s shapes. JAX's tolerances were
  2e-6 (conv), exact (pool) and 1e-5 (unpool) for the outputs; the port's
  are bitwise (a tile's window columns, and so its sums, are the
  unsharded op's), and its gradients, whose halo rows add in another
  order, within 1e-6 relative (f32; JAX 1e-4) and 1e-2 for the bf16
  pool (JAX's).
- A halo too narrow for the windows is flagged (``shard_ok`` False) with
  finite outputs, and the halo doubled recovers the unsharded output
  bitwise (``test_spatial.py:279-331, 718-763``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sph3d_gcn_tpu.parallel import spatial as jax_spatial
from sph3d_gcn_torch.ops.dense import (
    build_dense_graph,
    dense_depthwise_conv3d,
    dense_max_pool3d,
    dense_weighted_interpolate,
)
from sph3d_gcn_torch.parallel import RankPool, spatial

import torch_spatial_workers as W
from test_torch_cli import one_torch_thread  # noqa: F401

R = 4
CASES = [(2, 4), (5, 4), (8, 2)]
KERNEL = (8, 2, 2)
F_BINS = 8 * 2 * 2 + 1


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(R, timeout=240,
                  store_dir=str(tmp_path_factory.mktemp("store"))) as p:
        yield p


def _jax_rows(fn, x: np.ndarray) -> np.ndarray:
    """``fn`` per shard of x's rows under shard_map over R devices,
    the shards' outputs concatenated."""
    mesh = Mesh(np.array(jax.devices()[:R]), ("points",))
    f = shard_map(fn, mesh=mesh, in_specs=P(None, "points", None),
                  out_specs=P(None, "points", None))
    return np.asarray(f(jnp.asarray(x)))


def _blocks(a: np.ndarray) -> list[np.ndarray]:
    return np.split(a, R, axis=1)


def _case(halo, n_local):
    b, c = 2, 3
    x = np.arange(b * R * n_local * c, dtype=np.float32).reshape(
        b, R * n_local, c) + 1.0
    y = np.random.default_rng(halo * 10 + n_local).standard_normal(
        (b, R * (n_local + 2 * halo), c)).astype(np.float32)
    return x, y, halo


@pytest.fixture(scope="module")
def exchanged(pool):
    return pool.run(W.exchange, [_case(*c) for c in CASES])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_halo_exchange_matches_numpy_and_jax(exchanged, i):
    halo, n_local = CASES[i]
    x, _, _ = _case(halo, n_local)
    xpad = np.pad(x, ((0, 0), (halo, halo), (0, 0)))
    ref = _blocks(_jax_rows(functools.partial(
        jax_spatial.halo_exchange, halo=halo, axis_name="points"), x))
    for r, got in enumerate(exchanged):
        want = xpad[:, r * n_local:r * n_local + n_local + 2 * halo]
        np.testing.assert_array_equal(got[i]["exchange"], want)
        np.testing.assert_array_equal(got[i]["exchange"], ref[r])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_halo_reduce_is_the_exchange_transpose(exchanged, i):
    halo, n_local = CASES[i]
    x, y, _ = _case(halo, n_local)
    ref = _blocks(_jax_rows(functools.partial(
        jax_spatial.halo_reduce, halo=halo, axis_name="points"), y))
    lhs = sum(float(np.vdot(g[i]["exchange"], np.split(y, R, 1)[r]))
              for r, g in enumerate(exchanged))
    rhs = sum(float(np.vdot(np.split(x, R, 1)[r], g[i]["reduce"]))
              for r, g in enumerate(exchanged))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6)
    for r, got in enumerate(exchanged):
        np.testing.assert_array_equal(got[i]["reduce"], ref[r])
        # the gradient through each is the other
        np.testing.assert_array_equal(got[i]["dx"], got[i]["reduce"])
        np.testing.assert_array_equal(got[i]["dy"], got[i]["exchange"])


def test_all_rows_and_psum_replicated_carry_the_true_gradient(pool):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, R * 3, 5)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    out = pool.run(W.gathered, x, w)
    true = np.cos(x.astype(np.float64)) * w
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["full"], x)
        np.testing.assert_allclose(got["loss"], np.sum(np.sin(
            x.astype(np.float64)) * w), rtol=1e-6)
        np.testing.assert_allclose(got["dx"], _blocks(true)[r], rtol=1e-6,
                                   atol=1e-7)


def _sorted_cloud(rng, b, n):
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    order = np.argsort(pts[..., 0], axis=1)
    return np.take_along_axis(pts, order[..., None], axis=1)


def _uniform_cube(rng, b, n):
    cube = rng.uniform(0.0, 1.0, (b, n, 3)).astype(np.float32)
    order = np.argsort(cube[..., 0], axis=1)
    return np.take_along_axis(cube, order[..., None], axis=1)


def _op_case(op):
    """(db, query, features, graph kwargs, halo blocks, filter) at
    test_spatial.py's shapes for ``op``."""
    if op == "conv":
        rng = np.random.default_rng(7)
        pts = _sorted_cloud(rng, 2, 2048)
        feats = rng.standard_normal((2, 2048, 6)).astype(np.float32)
        filt = rng.standard_normal((F_BINS, 6, 2)).astype(np.float32)
        graph = dict(radius=0.15, nn_sample=7, kernel=KERNEL, window=512,
                     self_graph=True)
        return pts, pts, feats, graph, 512 // 128, filt
    if op == "pool":
        rng = np.random.default_rng(9)
        pts = _sorted_cloud(rng, 2, 2048)
        feats = rng.standard_normal((2, 2048, 64)).astype(np.float32)
        feats = torch.from_numpy(feats).bfloat16().float().numpy()
        graph = dict(radius=0.15, nn_sample=8, kernel=None, window=1024,
                     self_graph=False)
        return pts, pts[:, ::4].copy(), feats, graph, 1024 // 128, None
    rng = np.random.default_rng(10)
    pts = _uniform_cube(rng, 2, 4096)
    coarse = pts[:, ::4].copy()
    feats = rng.standard_normal((2, 1024, 32)).astype(np.float32)
    graph = dict(radius=0.2, nn_sample=6, kernel=None, window=768,
                 self_graph=False, need_dist=True, growth_steps=12)
    return coarse, pts, feats, graph, 768 // 128, None


def _unsharded(op, db, query, feats, graph, filt):
    """The unsharded op: output and the gradients of sum(sin(out))."""
    dnbh = build_dense_graph(torch.from_numpy(db), torch.from_numpy(query),
                             **graph)
    assert bool(dnbh.ok)
    x = torch.from_numpy(feats).requires_grad_(True)
    inputs = [x]
    if op == "conv":
        ft = torch.from_numpy(filt).requires_grad_(True)
        inputs.append(ft)
        out = dense_depthwise_conv3d(x, ft, dnbh)
    elif op == "pool":
        out = dense_max_pool3d(x.bfloat16(), dnbh, with_index=False)[0]
    else:
        out = dense_weighted_interpolate(x, dnbh)
    torch.sin(out.float()).sum().backward()
    return out.detach().float().numpy(), [t.grad.numpy() for t in inputs]


@pytest.mark.parametrize("op,grad_tol", [("conv", 1e-6), ("pool", 1e-2),
                                         ("unpool", 1e-6)])
def test_sharded_op_matches_unsharded(pool, op, grad_tol):
    db, query, feats, graph, halo_b, filt = _op_case(op)
    ranks = pool.run(W.sharded_op, op, db, query, feats, graph, halo_b,
                     filt)
    ref_out, ref_grads = _unsharded(op, db, query, feats, graph, filt)
    assert all(r["shard_ok"] for r in ranks)
    for r in ranks:
        assert all(r["same"].values()), r["same"]
    got = np.concatenate([r["out"] for r in ranks], axis=1)
    np.testing.assert_array_equal(got[:, :ref_out.shape[1]], ref_out)
    dx = np.concatenate([r["grads"][0] for r in ranks], axis=1)
    np.testing.assert_allclose(dx, ref_grads[0], rtol=grad_tol,
                               atol=grad_tol * np.abs(ref_grads[0]).max())
    if op == "conv":
        dfilt = sum(r["grads"][1] for r in ranks)
        np.testing.assert_allclose(
            dfilt, ref_grads[1], rtol=grad_tol,
            atol=grad_tol * np.abs(ref_grads[1]).max())


def test_narrow_halo_is_flagged_and_a_wider_one_recovers(pool):
    rng = np.random.default_rng(8)
    pts = _sorted_cloud(rng, 1, 1024)
    feats = rng.standard_normal((1, 1024, 6)).astype(np.float32)
    filt = rng.standard_normal((F_BINS, 6, 1)).astype(np.float32)
    graph = dict(radius=0.25, nn_sample=5, kernel=KERNEL, window=512,
                 self_graph=True)
    ref_out, _ = _unsharded("conv", pts, pts, feats, graph, filt)
    narrow = pool.run(W.sharded_op, "conv", pts, pts, feats, graph, 1, filt)
    assert not all(r["shard_ok"] for r in narrow)
    assert all(np.isfinite(r["out"]).all() for r in narrow)
    wide = pool.run(W.sharded_op, "conv", pts, pts, feats, graph, 2, filt)
    assert all(r["shard_ok"] for r in wide)
    got = np.concatenate([r["out"] for r in wide], axis=1)
    np.testing.assert_array_equal(got, ref_out)


@pytest.mark.parametrize("rows,shards", [(8192, 2), (2048, 2), (768, 2),
                                         (384, 2), (768, 4), (128, 2),
                                         (1000, 1), (256, 4)])
def test_shardable_rows_is_jax(rows, shards):
    assert spatial.shardable_rows(rows, shards) == \
        jax_spatial.shardable_rows(rows, shards)


def test_query_shard_needs_aligned_split_tiles():
    pts = torch.from_numpy(_sorted_cloud(np.random.default_rng(1), 1, 384))
    with pytest.raises(ValueError, match="do not split"):
        build_dense_graph(pts, pts, 0.2, 8, KERNEL, 256, self_graph=True,
                          query_shard=(0, 2))
    with pytest.raises(ValueError, match="TILE-aligned"):
        build_dense_graph(pts, pts[:, :300], 0.2, 8, None, 256,
                          query_shard=(0, 1))
