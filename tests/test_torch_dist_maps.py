"""PyTorch port vs JAX: the dense query's distance maps and the ops that
read them, plus the average pools.

- Maps: the port's plain queries with ``need_dist`` (``build_dense_graph``
  on the CPU runs ``dense_query_plain`` / ``growth_query_plain``) against
  JAX's ``build_dense_graph(..., need_dist=True)``, whose Pallas query
  kernels run in interpret mode: rank maps, sort-grouped bin maps,
  ungrouped bin maps (``dense_query_pallas`` with no sort axis) and growth
  maps with Gaussian outliers. Packed maps and growth steps are exact;
  each distance is within 1 ulp of JAX's: XLA's CPU code rounds the
  candidate distance ``sqrt(dx*dx + dy*dy + dz*dz)`` differently (it may
  contract the sum of squares into fused multiply-adds), while the port
  rounds after every operation as the CUDA kernels do. No entry is
  selected on one side only (the packed maps are equal), and zeros are
  exact.
- Ops: ``dense_weighted_interpolate``, ``dense_ids_prob``,
  ``dense_avg_pool3d`` and the per-edge ``avg_pool3d`` (plain and
  windowed gathers): forward and the gradient in ``inputs``, f32 and bf16,
  tolerances stated per test.
- The per-edge sphere query's radius growth (``self_graph=False``)
  against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import dense as jd
from sph3d_gcn_tpu.ops import pool as jpool
from sph3d_gcn_tpu.ops.neighbor import build_sphere_neighbor as j_sphere
from sph3d_gcn_tpu.ops.pallas.query_kernel import (
    blocked_db,
    dense_query_pallas,
)
from sph3d_gcn_torch.ops import dense as td
from sph3d_gcn_torch.ops import pool as tpool
from sph3d_gcn_torch.ops.neighbor import build_sphere_neighbor
from sph3d_gcn_torch.ops.query import dense_query_plain

KERNEL = (8, 2, 2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def sorted_clouds(seed, b=2, n=600, gaussian=False):
    """Ellipsoid surfaces (or Gaussian blobs, whose outliers make queries
    grow), cloud i sorted along axis (i + 1) % 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    if not gaussian:
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    for i in range(b):
        v[i] = v[i][np.argsort(v[i, :, (i + 1) % 3], kind="stable")]
    return v


def assert_dist_within_ulp(got, ref):
    """Equal zeros, and every entry within 1 ulp (see the docstring)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got == 0, ref == 0)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1, int(ulps.max())


def both_graphs(db, q, radius, k, kernel, window, self_graph=False,
                growth_steps=0):
    jg = jax.jit(lambda d, e: jd.build_dense_graph(
        d, e, radius, k, kernel, window=window, self_graph=self_graph,
        need_dist=True, growth_steps=growth_steps))(jnp.asarray(db),
                                                    jnp.asarray(q))
    tg = td.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                              radius, k, kernel, window=window,
                              self_graph=self_graph, need_dist=True,
                              growth_steps=growth_steps)
    return jg, tg


# (database, query, radius, K, kernel, window, self graph, growth steps)
GRAPHS = {
    "intra_grouped_bins": lambda p: (p, p, 0.2, 24, KERNEL, 384, True, 0),
    "pool_ranks": lambda p: (p, np.ascontiguousarray(p[:, ::4]), 0.2, 16,
                             None, 512, False, 0),
    "inter_growth": lambda p: (np.ascontiguousarray(p[:, ::6]), p, 0.06, 16,
                               None, 128, False, 6),
}


@functools.lru_cache(maxsize=None)
def graphs(name):
    """(JAX graph, port graph) of one GRAPHS case on seed-4 clouds."""
    db, q, r, k, kernel, w, self_graph, steps = GRAPHS[name](
        sorted_clouds(4))
    return both_graphs(db, q, r, k, kernel, w, self_graph, steps)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dist_maps_match_jax(name):
    jg, tg = graphs(name)
    np.testing.assert_array_equal(tg.packed.numpy(), np.asarray(jg.packed))
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    assert bool(tg.ok) == bool(jg.ok)
    assert tg.dist.dtype == torch.float32
    assert tg.dist.shape == tg.packed.shape
    assert_dist_within_ulp(tg.dist.numpy(), jg.dist)
    sel = tg.packed.numpy() > 0
    assert (tg.dist.numpy()[~sel] == 0).all()
    assert (tg.dist.numpy()[sel] > 0).sum() > 0.9 * (sel.sum() - 2 * 600)
    if name == "inter_growth":
        assert int(tg.count.max()) > 1


def test_dist_map_does_not_move_packed_maps():
    """The packed maps, counts and certificate are the same with and
    without the distance map (grouped bins and growth)."""
    for name in ("intra_grouped_bins", "inter_growth"):
        db, q, r, k, kernel, w, self_graph, steps = GRAPHS[name](
            sorted_clouds(4))
        _, tg = graphs(name)
        plain = td.build_dense_graph(
            torch.from_numpy(db), torch.from_numpy(q), r, k, kernel,
            window=w, self_graph=self_graph, growth_steps=steps)
        assert plain.dist is None
        assert torch.equal(plain.packed, tg.packed)
        assert torch.equal(plain.count, tg.count)
        assert bool(plain.ok) == bool(tg.ok)


def test_ungrouped_bin_dist_map_matches_the_jax_kernel():
    """Bin maps without a sort axis (mode 1 of K2), through the JAX Pallas
    query kernel directly."""
    pts = sorted_clouds(5)
    t = torch.from_numpy(pts)
    plan = td.plan_dense_query(t, t, 0.2, KERNEL, 384)
    packed, _, dist = dense_query_plain(
        plan.db_p, plan.q_p, plan.s_blk, plan.u_end, None, radius=0.2, k=24,
        kernel=KERNEL, window=plan.window, need_dist=True)
    ref, ref_dist, _ = dense_query_pallas(
        blocked_db(jnp.asarray(plan.db_p.numpy())),
        jnp.asarray(plan.q_p.numpy()), jnp.asarray(plan.s_blk.numpy()),
        jnp.asarray(plan.u_end.numpy()), radius=0.2, k=24, kernel=KERNEL,
        window=plan.window, need_dist=True, interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    assert_dist_within_ulp(dist.numpy(), ref_dist)
    only, _, no_dist = dense_query_plain(
        plan.db_p, plan.q_p, plan.s_blk, plan.u_end, None, radius=0.2, k=24,
        kernel=KERNEL, window=plan.window)
    assert torch.equal(only, packed) and no_dist is None


def test_growth_dist_map_with_outliers():
    """Gaussian clouds: outlying fine points grow far (up to 15 steps,
    the port's most)."""
    fine = sorted_clouds(6, n=700, gaussian=True)
    coarse = np.ascontiguousarray(fine[:, ::5])
    jg, tg = both_graphs(coarse, fine, 0.1, 8, None, 256, growth_steps=15)
    np.testing.assert_array_equal(tg.packed.numpy(), np.asarray(jg.packed))
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    assert bool(tg.ok) == bool(jg.ok)
    assert_dist_within_ulp(tg.dist.numpy(), jg.dist)
    # rows that grew select neighbors farther than the base radius
    sqrt_r = np.sqrt(np.float32(0.1))
    assert (tg.dist.numpy() > sqrt_r).any()


# ------------------------------------------------------------------ ops


def _grad_jax(fn, feats, cot, jdt):
    """The output and the gradient of ``sum(fn(f).astype(f32) * cot)``,
    from one jitted forward and its VJP (the cast's transpose rounds
    ``cot`` to the output dtype)."""
    def run(f):
        out, vjp = jax.vjp(fn, f)
        return out, vjp(jnp.asarray(cot).astype(out.dtype))[0]
    out, grad = jax.jit(run)(jnp.asarray(feats, jdt))
    return np.asarray(out, np.float32), np.asarray(grad, np.float32)


def _grad_torch(fn, feats, cot, tdt):
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    out = fn(x)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out.detach().float().numpy(), x.grad.float().numpy(), out.dtype


# f32: sums of at most K products in another order (forward), window
# gradients summed into the cloud in another order (backward). bf16: the
# outputs round once to bf16 on both sides (one bf16 ulp, 2^-8 of the
# value, where the f32 sums straddle a rounding boundary); the gradients
# are f32 sums of products of bf16 values and bf16 weights, rounded once
# to bf16.
OP_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _cot(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_interpolate_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jg, tg = graphs("inter_growth")
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((2, 100, 96)).astype(np.float32)
    cot = _cot(rng, (2, 600, 96))
    ref, ref_g = _grad_jax(lambda f: jd.dense_weighted_interpolate(f, jg),
                           feats, cot, jdt)
    got, got_g, out_dtype = _grad_torch(
        lambda x: td.dense_weighted_interpolate(x, tg), feats, cot, tdt)
    assert out_dtype == tdt and got.shape == (2, 600, 96)
    tol = OP_TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_g, ref_g, rtol=tol,
                               atol=tol * np.abs(ref_g).max())
    # the weights of a row with neighbors sum to 1 (to f32 rounding)
    w = td.interpolation_weights(tg).sum(dim=-1).reshape(2, -1)[:, :600]
    has = tg.count > 0
    assert has.all()
    np.testing.assert_allclose(w[has].numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="need_dist"):
        td.dense_weighted_interpolate(
            torch.from_numpy(feats), td.build_dense_graph(
                torch.from_numpy(np.ascontiguousarray(
                    sorted_clouds(4)[:, ::6])),
                torch.from_numpy(sorted_clouds(4)), 0.06, 16, None,
                window=128, growth_steps=6))


def test_ids_prob_matches_jax():
    """The mean selected sqrt-space distance per query: within 4 f32 ulps
    of JAX's (each distance within 1 ulp, summed in another order)."""
    jg, tg = graphs("intra_grouped_bins")
    ref = np.asarray(jd.dense_ids_prob(jg))
    got = td.dense_ids_prob(tg)
    assert got.dtype == torch.float32 and got.shape == (2, 600)
    np.testing.assert_allclose(got.numpy(), ref, rtol=4 * 2 ** -23, atol=0)
    assert (got > 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_avg_pool_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    jg, tg = graphs("pool_ranks")
    rng = np.random.default_rng(12)
    feats = rng.standard_normal((2, 600, 128)).astype(np.float32)
    cot = _cot(rng, (2, 150, 128))
    ref, ref_g = _grad_jax(lambda f: jd.dense_avg_pool3d(f, jg), feats,
                           cot, jdt)
    got, got_g, out_dtype = _grad_torch(
        lambda x: td.dense_avg_pool3d(x, tg), feats, cot, tdt)
    assert out_dtype == tdt and got.shape == (2, 150, 128)
    tol = OP_TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_g, ref_g, rtol=tol,
                               atol=tol * np.abs(ref_g).max())
    # the same masked mean as the unpool
    np.testing.assert_array_equal(
        got, td.dense_mean_interpolate(torch.from_numpy(feats).to(tdt),
                                       tg).float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 256])
def test_edge_avg_pool_matches_jax(window, dtype):
    """The per-edge average pool on a gathered pool graph, through the
    plain gather (``window=None``) and through the windowed gather (K8's
    plain version, K9's in the backward)."""
    jdt, tdt = DTYPES[dtype]
    pts = sorted_clouds(7)
    nbh = build_sphere_neighbor(torch.from_numpy(pts), torch.from_numpy(pts),
                                radius=0.2, nn_sample=16, self_graph=True)
    idx, cnt = nbh.idx[:, ::4].contiguous(), nbh.count[:, ::4].contiguous()
    rng = np.random.default_rng(13)
    feats = rng.standard_normal((2, 600, 64)).astype(np.float32)
    cot = _cot(rng, (2, 150, 64))
    j_idx = jnp.asarray(idx.numpy().astype(np.int32))
    j_cnt = jnp.asarray(cnt.numpy().astype(np.int32))
    ref, ref_g = _grad_jax(
        lambda f: jpool.avg_pool3d(f, j_idx, j_cnt, window=window), feats,
        cot, jdt)
    got, got_g, out_dtype = _grad_torch(
        lambda x: tpool.avg_pool3d(x, idx, cnt, window=window), feats, cot,
        tdt)
    assert out_dtype == tdt and got.shape == (2, 150, 64)
    tol = OP_TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_g, ref_g, rtol=tol,
                               atol=tol * np.abs(ref_g).max())


# ------------------------------------------- per-edge query radius growth


def test_sphere_query_grows_radius_of_isolated_queries():
    """JAX's default ``self_graph=False`` grows the radius of a query with
    no neighbor by +0.05 until it finds one (ref tf_nnquery_gpu.cu:30-60);
    the port's query does the same: equal idx and count, dist within
    1e-5 (the JAX test tolerance of the query)."""
    db = sorted_clouds(8, n=300)
    q = np.ascontiguousarray(db[:, ::10]).copy()
    q[:, :4] += np.float32(0.6)          # isolated: grow 8+ steps
    q[:, 4] = np.float32(3.0)            # far out: grows about 50 steps
    jn = j_sphere(jnp.asarray(db), jnp.asarray(q), radius=0.1, nn_sample=8)
    tn = build_sphere_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                               radius=0.1, nn_sample=8)
    np.testing.assert_array_equal(tn.idx.numpy(), np.asarray(jn.idx))
    np.testing.assert_array_equal(tn.count.numpy(), np.asarray(jn.count))
    np.testing.assert_allclose(tn.dist.numpy(), np.asarray(jn.dist),
                               rtol=1e-5, atol=1e-5)
    assert (tn.count > 0).all()
    # without growth the isolated queries select nothing; the others are
    # unchanged
    fixed = build_sphere_neighbor(torch.from_numpy(db), torch.from_numpy(q),
                                  radius=0.1, nn_sample=8, self_graph=True)
    lone = fixed.count == 0
    assert lone[:, 4].all() and int(lone.sum()) >= 6
    assert torch.equal(fixed.idx[~lone], tn.idx[~lone])
    assert torch.equal(fixed.count[~lone], tn.count[~lone])
