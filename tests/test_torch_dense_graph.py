"""PyTorch port vs JAX: the dense windowed graph build (exact).

``build_dense_graph`` on numpy-seeded, axis-sorted clouds — intra graphs
with SORT-GROUPED (8, 2, 2) bin maps, pool graphs with rank maps, and the
decoders' fine->coarse graphs with radius growth — must give the JAX op's
packed maps byte for byte and equal ``s_blk``, ``count``, ``axis`` and
``ok``. JAX runs its Pallas query kernels in interpret mode on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import dense as jd
from sph3d_gcn_tpu.ops.pallas.query_kernel import (
    blocked_db,
    dense_query_pallas,
)
from sph3d_gcn_torch.ops import dense as td
from sph3d_gcn_torch.ops.query import bins_822, growth_query_plain

KERNEL = (8, 2, 2)


def sorted_clouds(seed, b=3, n=1000):
    """Ellipsoid surfaces, cloud i sorted along axis i % 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    for i in range(b):
        v[i] = v[i][np.argsort(v[i, :, i % 3], kind="stable")]
    return v


def assert_same_graph(got, ref):
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.s_blk.numpy(), np.asarray(ref.s_blk))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    assert bool(got.ok) == bool(ref.ok)
    assert got.grouped == ref.grouped and got.k_max == ref.k_max
    assert got.num_query == ref.num_query and got.num_db == ref.num_db
    if ref.axis is None:
        assert got.axis is None
    else:
        np.testing.assert_array_equal(got.axis.numpy(), np.asarray(ref.axis))


@pytest.mark.parametrize("window,radius,k,expect_ok", [
    (640, 0.15, 24, True),    # narrow enough that tiles start past row 0
    (128, 0.3, 64, False),    # slab wider than the window
])
def test_intra_grouped_bin_graph(window, radius, k, expect_ok):
    pts = sorted_clouds(0)
    ref = jd.build_dense_graph(jnp.asarray(pts), jnp.asarray(pts), radius, k,
                               KERNEL, window=window, self_graph=True)
    got = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(pts),
                               radius, k, KERNEL, window=window,
                               self_graph=True)
    assert_same_graph(got, ref)
    assert bool(got.ok) is expect_ok
    assert got.grouped and sorted(set(got.axis.tolist())) == [0, 1, 2]
    assert (got.s_blk > 0).any()
    assert int(got.count.max()) == k      # the first-K cut is exercised


def test_pool_rank_graph():
    pts = sorted_clouds(1)
    coarse = pts[:, ::4]                  # a sorted subsequence
    ref = jd.build_dense_graph(jnp.asarray(pts), jnp.asarray(coarse), 0.15,
                               16, None, window=896)
    got = td.build_dense_graph(torch.from_numpy(pts),
                               torch.from_numpy(coarse), 0.15, 16, None,
                               window=896)
    assert_same_graph(got, ref)
    assert bool(got.ok) and got.k_max == 16 and not got.grouped
    assert (got.s_blk > 0).any()


def test_pool_graph_zero_count_flips_ok():
    pts = sorted_clouds(2, b=2, n=300)
    far = pts[:, :40].copy()
    far[:, :, 1] += 5.0                   # queries with no neighbor in range
    far = far[:, np.argsort(far[0, :, 0], kind="stable")]
    ref = jd.build_dense_graph(jnp.asarray(pts), jnp.asarray(far), 0.2, 8,
                               None, window=384)
    got = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(far),
                               0.2, 8, None, window=384)
    assert_same_graph(got, ref)
    assert not bool(got.ok)


def test_unsorted_cloud_flips_ok():
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((2, 300, 3)).astype(np.float32)
    ref = jd.build_dense_graph(jnp.asarray(pts), jnp.asarray(pts), 0.5, 16,
                               KERNEL, window=256, self_graph=True)
    got = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(pts),
                               0.5, 16, KERNEL, window=256, self_graph=True)
    assert_same_graph(got, ref)
    assert not bool(got.ok)


def test_ungrouped_bins_and_signed_zero_rule():
    # vertically aligned candidates (dx == dy == +-0) and the (-, 0) ray
    from sph3d_gcn_tpu.ops.pallas.query_kernel import _bins_822

    dx = np.array([0.0, -0.0, 0.0, -0.0, 0.05, -0.05, 0.03, 0.0],
                  np.float32)
    dy = np.array([0.0, 0.0, -0.0, -0.0, 0.0, 0.0, -0.03, 0.04], np.float32)
    dz = np.array([0.02, -0.02, 0.0, -0.0, 0.01, -0.01, 0.0, 0.0],
                  np.float32)
    d3 = np.sqrt(dx * dx + dy * dy + dz * dz)
    for axis in (None, 0, 1, 2):
        ga = None if axis is None else jnp.int32(axis)
        ref = np.asarray(_bins_822(*map(jnp.asarray, (dx, dy, dz, d3)),
                                   0.1, KERNEL, ga))
        got = bins_822(*map(torch.from_numpy, (dx, dy, dz, d3)), 0.1, KERNEL,
                       None if axis is None else torch.tensor(axis))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_grouped_perm_matches_jax():
    np.testing.assert_array_equal(td._grouped_perm(33), jd._grouped_perm(33))
    np.testing.assert_array_equal(td._grouped_perm(49), jd._grouped_perm(49))


def test_unported_options_raise():
    # distance maps (tests/test_torch_dist_maps.py) and query sharding
    # (tests/test_torch_spatial.py) are ported: a shard count that does
    # not split the query tiles raises
    pts = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError, match="do not split"):
        td.build_dense_graph(pts, pts, 0.1, 8, None, window=128,
                             query_shard=(0, 2))
    g = td.build_dense_graph(pts, pts, 0.1, 8, None, window=128,
                             need_dist=True)
    assert g.dist.shape == g.packed.shape


def growth_case(name):
    """(database, query, radius, K, window, growth_steps) of a decoder
    inter graph: fine queries search a sorted subsequence of their cloud."""
    if name == "exhausted":
        pts = sorted_clouds(1)
        return pts[:, ::8].copy(), pts, 0.05, 16, 384, 3
    pts = sorted_clouds(2, b=2, n=2000)
    window, steps = {"covered": (512, 12), "slab_left": (384, 8)}[name]
    return pts[:, ::3].copy(), pts, 0.01, 16, window, steps


@pytest.mark.parametrize("case,expect_ok", [
    ("covered", True),       # rows grow, every grown slab in the window
    ("exhausted", False),    # rows with no candidate after G steps
    ("slab_left", False),    # a grown slab overruns the window
])
def test_growth_graph(case, expect_ok):
    db, q, radius, k, window, steps = growth_case(case)
    ref = jd.build_dense_graph(jnp.asarray(db), jnp.asarray(q), radius, k,
                               None, window=window, growth_steps=steps)
    got = td.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                               radius, k, None, window=window,
                               growth_steps=steps)
    assert_same_graph(got, ref)
    assert bool(got.ok) is expect_ok and got.k_max == k
    plan = td.plan_dense_query(torch.from_numpy(db), torch.from_numpy(q),
                               radius, None, window, steps)
    assert bool(plan.ok)                 # the base-radius slabs are covered
    zero_rows = int((got.count == 0).sum())
    assert (zero_rows > 0) is (case == "exhausted")
    _, row_steps, _, _ = growth_query_plain(
        plan.db_p, plan.q_p, plan.s_blk, plan.u_end, radius=radius, k=k,
        window=plan.window, growth_steps=steps)
    assert int(row_steps.max()) > 0     # some rows grew
    with pytest.raises(ValueError, match="selection-only"):
        td.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                             radius, k, KERNEL, window=window,
                             growth_steps=steps)


@pytest.mark.parametrize("case", ["covered", "exhausted"])
def test_growth_query_matches_the_jax_kernel(case):
    """The plain growth query's maps and per-row steps against the JAX
    Pallas kernel's maps and per-tile maximum step (``gmax``)."""
    db, q, radius, k, window, steps = growth_case(case)
    plan = td.plan_dense_query(torch.from_numpy(db), torch.from_numpy(q),
                               radius, None, window, steps)
    packed, row_steps, _, _ = growth_query_plain(
        plan.db_p, plan.q_p, plan.s_blk, plan.u_end, radius=radius, k=k,
        window=plan.window, growth_steps=steps)
    ref, _, gmax = dense_query_pallas(
        blocked_db(jnp.asarray(plan.db_p.numpy())),
        jnp.asarray(plan.q_p.numpy()), jnp.asarray(plan.s_blk.numpy()),
        jnp.asarray(plan.u_end.numpy()), radius=radius, k=k, kernel=None,
        window=plan.window, growth_steps=steps, interpret=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(row_steps.amax(dim=-1).numpy(),
                                  np.asarray(gmax))
    assert row_steps.dtype == torch.int8 and int(row_steps.max()) > 0
    # rows that select nothing report step 0
    dead = (packed > 0).sum(dim=-1) == 0
    assert (row_steps[dead] == 0).all()
