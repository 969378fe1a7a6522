"""The dense sphere queries (K2, K7): squared-distance thresholds, row
counts, and the kernels against their plain versions.

CPU cases: ``query_thresholds`` and ``growth_thresholds`` against the
square-root form of the plain versions on every f32 within 2^16 ulps of
each threshold, for every radius the five configs serve (and every growth
radius, radial bin and self-loop threshold); numpy models of the kernels'
row walks (K2's rank maps, K7's least squared distance and grown
threshold) against the plain versions; the boundary operands (points at
exactly T - 1 ulp, T and T + 1 ulp in squared distance from a query)
against the thresholds; the plain versions' counts against JAX's
``DenseNeighborhood.count`` through ``build_dense_graph``.

``cuda`` cases (skipped without a card): K2 and K7 bitwise equal to the
plain versions in every mode, with and without the distance map, on
seeded clouds, on the boundary operands, on crowded rows (more than K in
range), empty rows, all-sentinel tiles and out-of-range ``u_end``, and at
the largest served window; each kernel's count equal to its map's nonzero
bytes a row.

JAX is imported inside the tests that compare with it: the card's
machine has none and runs the ``cuda`` cases with ``--noconftest``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.configs import (
    modelnet_config,
    ruemonge2014_config,
    s3dis_config,
    scannet_config,
    shapenet_config,
)
from sph3d_gcn_torch.data.synthetic import (
    boundary_clouds,
    growth_boundary_clouds,
    query_operands,
    surface_clouds,
    ulp_triples,
)
from sph3d_gcn_torch.ops import dense as D
from sph3d_gcn_torch.ops import query as Q

TILE = 128
ULPS = 1 << 16
KERNEL = (8, 2, 2)
# every radius of the port's five configs
SERVED_RADII = tuple(sorted(set(
    modelnet_config().radius + shapenet_config().radius
    + s3dis_config().radius + scannet_config().radius
    + ruemonge2014_config().radius)))
MAX_GROWTH = 15


def around(t: float) -> torch.Tensor:
    """Every f32 within ULPS ulps of ``t >= 0`` (and >= 0 itself)."""
    b = int(np.float32(t).view(np.uint32))
    bits = np.arange(max(b - ULPS, 0), b + ULPS + 1, dtype=np.int64)
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32))


def sqrt32(s: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as CUDA's ``sqrtf`` and
    ``torch.sqrt`` on the card give it: the f64 root rounded to f32 (a
    double rounding that is exact for square roots). ``torch.sqrt`` on
    the CPU is not always correctly rounded (off by one ulp on about 0.6%
    of random f32 with the AVX-512 build), so it is not the reference
    here."""
    return torch.sqrt(s.double()).float()


def in_range(d3: torch.Tensor, radius) -> torch.Tensor:
    """The plain versions' range test on distances ``d3``."""
    r32 = torch.tensor(radius, dtype=torch.float32)
    return (d3 < r32) & ((d3 - r32).abs() > Q._BOUNDARY_EPS)


def test_served_radii_are_the_configs():
    """SERVED_RADII holds every radius of JAX's five configs."""
    from sph3d_gcn_tpu import configs as jc

    radii = set()
    for cfg in (jc.modelnet_config, jc.shapenet_config, jc.scannet_config,
                jc.s3dis_config, jc.ruemonge2014_config):
        radii |= set(cfg().radius)
    assert radii == set(SERVED_RADII)


@pytest.mark.parametrize("radius", SERVED_RADII)
def test_thresholds_equal_the_square_root_form(radius):
    """For each served radius: the range test, every radial bin test of
    1-4 radial bins and the self-loop test flip at their thresholds, on
    every f32 within 2^16 ulps of each, exactly as the square-root form
    does; and each growth radius's range test at its threshold."""
    for q_bins in range(1, Q._MAX_Q_BINS + 1):
        t_in, t_radial, t_far = Q.query_thresholds(radius, q_bins)
        radial, far = Q.bin_thresholds(radius, q_bins)
        assert len(t_radial) == q_bins - 1
        s = around(t_in)
        assert torch.equal(in_range(sqrt32(s), radius), s < t_in)
        for thr, t in zip(radial, t_radial):
            s = around(t)
            assert torch.equal(sqrt32(s) >= thr, s >= t)
        s = around(t_far)
        assert torch.equal(sqrt32(s) > far, s >= t_far)
        assert t_in > 0 and t_far > 0
    radii = Q.growth_radii(radius, MAX_GROWTH)
    ts = Q.growth_thresholds(radius, MAX_GROWTH)
    assert len(ts) == MAX_GROWTH + 1 and list(ts) == sorted(ts)
    assert ts[0] == Q.query_thresholds(radius, 1)[0]
    assert Q.growth_thresholds(radius, 3) == ts[:4]
    for r, t in zip(radii, ts):
        s = around(t)
        assert torch.equal(in_range(sqrt32(s), r), s < t)


# --- operands ---


def sorted_clouds(seed, b=3, n=900):
    """Ellipsoid surfaces, cloud i sorted along axis i % 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    for i in range(b):
        v[i] = v[i][np.argsort(v[i, :, i % 3], kind="stable")]
    return v


def padded(db: np.ndarray, q: np.ndarray, device="cpu", window=None,
           rng=None):
    """``synthetic.query_operands`` as tensors on ``device``: (args,
    window)."""
    *arrays, window = query_operands(db, q, window, rng)
    return tuple(torch.from_numpy(a).to(device) for a in arrays), window


def boundary_operands(radius, q_bins, seed, rows=2 * TILE, device="cpu"):
    """Two clouds of points at T - 1 ulp, T and T + 1 ulp of each
    threshold of the rows on the x axis (range, radial bins, self loop)."""
    t_in, t_radial, t_far = Q.query_thresholds(radius, q_bins)
    db, q = boundary_clouds((t_in, *t_radial, t_far), rows,
                            np.random.default_rng(seed))
    return padded(db, q, device)


def growth_operands(radius, steps, seed, rows=2 * TILE, device="cpu"):
    """Growth rows at each threshold's boundaries
    (``synthetic.growth_boundary_clouds``): (args, window, the rows'
    steps, the rows never alive)."""
    db, q, want, dead = growth_boundary_clouds(
        Q.growth_thresholds(radius, steps), rows,
        np.random.default_rng(seed))
    args, window = padded(db, q, device)
    return args, window, want, dead


def sq_dist(args, window):
    """(B*nT, TILE, W) squared distances of every query row and window
    column, as the plain versions form them, and the live mask."""
    db_p, q_p, s_blk, u_end = args[:4]
    batch, m_pad, _ = q_p.shape
    g_all = batch * (m_pad // TILE)
    cols = torch.arange(window)
    rows = s_blk.reshape(g_all, 1) * TILE + cols
    b_of_g = torch.arange(batch).repeat_interleave(m_pad // TILE)
    win = db_p[b_of_g[:, None], rows]
    q = q_p.reshape(g_all, TILE, 3)
    d = win[:, None] - q[:, :, None]
    s = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    live = cols < u_end.reshape(g_all, 1).clamp(1, window // TILE) * TILE
    return s, live[:, None, :]


def rank_model(s, live, t_in, k):
    """The kernels' row walk on a threshold, in torch on the CPU:
    columns with s < t_in ranked in window order, the first k kept."""
    inr = (s < t_in) & live
    rank = torch.cumsum(inr.to(torch.int32), -1)
    keep = inr & (rank <= k)
    return torch.where(keep, rank, 0).to(torch.int8), keep.sum(-1)


# --- CPU: models and operands against the plain versions ---


@pytest.mark.parametrize("radius,k", [(0.1, 64), (0.4, 8)])
def test_k2_rank_model_matches_plain(radius, k):
    """K2's rank maps and counts from ``s < t_in`` equal the plain
    version's square-root form, on sorted clouds with drawn windows."""
    pts = sorted_clouds(1)
    args, window = padded(pts, pts[:, ::3], window=384,
                          rng=np.random.default_rng(2))
    packed, count, _ = Q.dense_query_plain(*args, None, radius=radius, k=k,
                                           kernel=None, window=window)
    s, live = sq_dist(args, window)
    want, n = rank_model(s, live, Q.query_thresholds(radius, 1)[0], k)
    assert torch.equal(packed.reshape(want.shape), want)
    assert torch.equal(count.reshape(n.shape), n.to(torch.int32))
    assert torch.equal(count, (packed > 0).sum(-1).reshape(count.shape))
    assert int(count.max()) == k or k == 64


def growth_model(args, window, radius, steps, k):
    """K7's two passes on the CPU: the row's least live squared distance
    gives g* (the thresholds at or below it) and the grown threshold
    t_{g*}; then K2's walk on it."""
    ts = torch.tensor(Q.growth_thresholds(radius, steps) + (np.inf,))
    s, live = sq_dist(args, window)
    s_min = torch.where(live, s, torch.inf).amin(-1)
    gstar = (ts[None, None, :] <= s_min[..., None]).sum(-1)
    alive = gstar < steps + 1
    t_sel = ts[gstar.clamp(max=steps)]
    packed, n = rank_model(s, live, t_sel[..., None], k)
    packed = torch.where(alive[..., None], packed, 0)
    return packed, torch.where(alive, gstar, 0), torch.where(alive, n, 0)


@pytest.mark.parametrize("steps", [1, 3, 12, 15])
def test_k7_model_matches_plain(steps):
    """K7's least-distance derivation of each row's step, and its ranks
    on the grown threshold, equal the plain version's count of failed
    radius tests, on growth-plan operands."""
    pts = sorted_clouds(4, n=1500)
    t = torch.from_numpy(pts)
    plan = D.plan_dense_query(t[:, ::3].contiguous(), t, 0.01, None, 512,
                              growth_steps=steps)
    args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end)
    packed, row_steps, count, _ = Q.growth_query_plain(
        *args, radius=0.01, k=8, window=plan.window, growth_steps=steps)
    want, want_steps, n = growth_model(args, plan.window, 0.01, steps, 8)
    assert torch.equal(packed.reshape(want.shape), want)
    assert torch.equal(row_steps.reshape(want_steps.shape).long(),
                       want_steps)
    assert torch.equal(count.reshape(n.shape), n.to(torch.int32))
    assert int(row_steps.max()) > 0


# The boundary operands sit where a square root off by one ulp flips a
# test, so here they are held to the correctly rounded form (sqrt32), not
# to the plain versions on the CPU; the card holds the kernels to the
# plain versions on them.


@pytest.mark.parametrize("radius", [0.1, 0.8])
def test_boundary_operands_meet_each_threshold(radius):
    """Each row meets T - 1 ulp, T and T + 1 ulp of each of its
    thresholds exactly once, and there the square-root form's range,
    radial-bin and self-loop tests flip as the thresholds say."""
    args, window = boundary_operands(radius, 2, seed=5)
    t_in, (t_r,), t_far = Q.query_thresholds(radius, 2)
    (thr,), far = Q.bin_thresholds(radius, 2)
    s, _ = sq_dist(args, window)
    for v in ulp_triples((t_in, t_r, t_far)):
        hit = (s == float(v)).sum(-1)
        assert int(hit.min()) == 1 and int(hit.max()) == 1
    d3 = sqrt32(s)
    assert torch.equal(in_range(d3, radius), s < t_in)
    assert torch.equal(d3 >= thr, s >= t_r)
    assert torch.equal(d3 > far, s >= t_far)
    assert int((s < t_in).sum(-1).max()) == 7


@pytest.mark.parametrize("steps", [3, 12])
def test_growth_operands_grow_as_designed(steps):
    """The growth rows' steps, from the square-root form's count of
    failed radius tests, are the designed ones, and the model gives them
    too, with rows never alive empty and some rows reaching K."""
    args, window, want, dead = growth_operands(0.1, steps, seed=7)
    s, live = sq_dist(args, window)
    d3 = sqrt32(s)
    g = sum((~in_range(d3, r)).long() for r in Q.growth_radii(0.1, steps))
    gstar = torch.where(live, g, steps + 1).amin(-1).reshape(-1)
    rows = want.size
    assert np.array_equal(np.where(dead, 0, gstar[:rows].numpy()), want)
    assert (gstar[:rows].numpy()[dead] == steps + 1).all()
    _, model_steps, n = growth_model(args, window, 0.1, steps, 8)
    assert np.array_equal(model_steps.reshape(-1)[:rows].numpy(), want)
    n = n.reshape(-1)[:rows].numpy()
    assert (n[dead] == 0).all() and (n[~dead] > 0).all() and n.max() == 8


@pytest.mark.parametrize("tiles", [1, 16, 32, 79, 96, 160, 320, 527, 528,
                                   1264])
def test_query_split(tiles):
    """The fewest blocks a tile (a power of two up to 16) that give the
    card 528 blocks: 8 warps of a block keep a row each at least."""
    split = Q.query_split(tiles)
    assert split in (1, 2, 4, 8, 16) and TILE // split >= 8
    assert tiles * split >= 528 or split == 16
    assert split == 1 or tiles * split // 2 < 528


def both_graphs(db, q, radius, k, kernel, window, growth_steps=0,
                self_graph=False):
    import jax.numpy as jnp

    from sph3d_gcn_tpu.ops import dense as jd

    jg = jd.build_dense_graph(jnp.asarray(db), jnp.asarray(q), radius, k,
                              kernel, window=window, self_graph=self_graph,
                              growth_steps=growth_steps)
    tg = D.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                             radius, k, kernel, window=window,
                             self_graph=self_graph,
                             growth_steps=growth_steps)
    return jg, tg


@pytest.mark.parametrize("case", ["intra_bins", "pool_ranks", "growth"])
def test_counts_match_jax(case):
    """The count that ``build_dense_graph`` takes from the plain query
    equals JAX's ``DenseNeighborhood.count`` and the map's nonzero bytes
    a row."""
    pts = sorted_clouds(8, b=2, n=700)
    if case == "intra_bins":
        db, q, kw = pts, pts, dict(radius=0.15, k=24, kernel=KERNEL,
                                   window=512, self_graph=True)
    elif case == "pool_ranks":
        db, q, kw = pts, np.ascontiguousarray(pts[:, ::4]), dict(
            radius=0.2, k=8, kernel=None, window=512)
    else:
        db, q, kw = np.ascontiguousarray(pts[:, ::5]), pts, dict(
            radius=0.02, k=8, kernel=None, window=256, growth_steps=3)
    jg, tg = both_graphs(db, q, **kw)
    np.testing.assert_array_equal(tg.count.numpy(), np.asarray(jg.count))
    nnz = (tg.packed > 0).sum(-1).reshape(tg.packed.shape[0], -1)
    assert torch.equal(tg.count, nnz[:, :tg.num_query].to(torch.int32))
    assert int(tg.count.max()) > 0


# --- on the card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


MODES = {"ranks": (None, False), "bins": (KERNEL, False),
         "grouped": (KERNEL, True)}


def assert_query_equal(args, axis, need_dist, **kw):
    """K2 against its plain version, bitwise: map, count, distance map;
    the count equal to the map's nonzero bytes a row; one launch."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches

    reset_kernel_launches()
    got = Q.dense_query(*args, axis, need_dist=need_dist, **kw)
    assert kernel_launches()["dense_query"] == 1
    ref = Q.dense_query_plain(*args, axis, need_dist=need_dist, **kw)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[1], (got[0] > 0).sum(-1).reshape(
        got[1].shape).to(torch.int32))
    return got


def assert_growth_equal(args, need_dist, **kw):
    """K7 against its plain version, bitwise: map, steps, count,
    distance map; one launch."""
    from sph3d_gcn_torch import kernel_launches, reset_kernel_launches

    reset_kernel_launches()
    got = Q.growth_query(*args, need_dist=need_dist, **kw)
    assert kernel_launches()["growth_query"] == 1
    ref = Q.growth_query_plain(*args, need_dist=need_dist, **kw)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("need_dist", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [8, 64])
def test_k2_matches_plain_on_cuda(cuda_device, mode, need_dist, k):
    kernel, grouped = MODES[mode]
    pts = torch.from_numpy(sorted_clouds(2)).to(cuda_device)
    for db, q in ((pts, pts), (pts, pts[:, ::4].contiguous())):
        plan = D.plan_dense_query(db, q, 0.25, kernel, 384)
        args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end)
        assert_query_equal(args, plan.axis if grouped else None, need_dist,
                           radius=0.25, k=k, kernel=kernel,
                           window=plan.window)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dist", [False, True])
@pytest.mark.parametrize("steps", [1, 3, 12, 15])
def test_k7_matches_plain_on_cuda(cuda_device, steps, need_dist):
    t = torch.from_numpy(sorted_clouds(4, n=2000)).to(cuda_device)
    plan = D.plan_dense_query(t[:, ::3].contiguous(), t, 0.01, None, 512,
                              growth_steps=steps)
    args = (plan.db_p, plan.q_p, plan.s_blk, plan.u_end)
    got = assert_growth_equal(args, need_dist, radius=0.01, k=16,
                              window=plan.window, growth_steps=steps)
    assert int(got[1].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("radius", SERVED_RADII)
def test_boundary_points_match_plain_on_cuda(cuda_device, radius):
    """Points at T - 1 ulp, T and T + 1 ulp of every threshold: K2 in
    every mode with and without the map, K7 at 3 and 12 steps."""
    args, window = boundary_operands(radius, 2, seed=9, device=cuda_device)
    axis = torch.tensor([0, 2], dtype=torch.int32, device=cuda_device)
    for mode, (kernel, grouped) in MODES.items():
        for need_dist in (False, True):
            assert_query_equal(args, axis if grouped else None, need_dist,
                               radius=radius, k=127, kernel=kernel,
                               window=window)
    for steps in (3, 12):
        g_args, g_window, want, _ = growth_operands(
            radius, steps, seed=steps, device=cuda_device)
        for need_dist in (False, True):
            got = assert_growth_equal(g_args, need_dist, radius=radius, k=8,
                                      window=g_window, growth_steps=steps)
            assert np.array_equal(
                got[1].reshape(-1)[:want.size].cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("need_dist", [False, True])
def test_crowded_empty_and_sentinel_tiles_on_cuda(cuda_device, need_dist):
    """Rows with far more than K in range (K reached inside a step; for
    K7 at its first radius), rows that grow, rows with none (queries moved
    away, a database of sentinels only), a query tile of sentinels only,
    drawn window starts and u_end outside [1, W/128]."""
    rng = np.random.default_rng(10)
    db = rng.random((2, 2000, 3), dtype=np.float32)
    q = db[:, :300].copy()
    q[:, 150:, 0] += 100.0                       # rows with none
    args, window = padded(db, q, cuda_device, window=1024, rng=rng)
    args[0][1] = 2e9                             # a sentinel database
    q_p = torch.full((2, 512, 3), 1e9, device=cuda_device)
    q_p[:, :384] = args[1]                       # a sentinel query tile
    args = (args[0], q_p, *(torch.cat([a, a[:, :1]], 1) for a in args[2:]))
    axis = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    for mode, (kernel, grouped) in MODES.items():
        got = assert_query_equal(args, axis if grouped else None, need_dist,
                                 radius=0.3, k=32, kernel=kernel,
                                 window=window)
        assert int(got[1].max()) == 32 and int(got[1][1].max()) == 0
    got = assert_growth_equal(args, need_dist, radius=0.05, k=32,
                              window=window, growth_steps=12)
    assert int(got[1].max()) > 0                 # rows that grow
    got = assert_growth_equal(args, need_dist, radius=0.3, k=32,
                              window=window, growth_steps=3)
    assert int(got[2].max()) == 32               # rows past K at once


@pytest.mark.cuda
def test_largest_served_window_on_cuda(cuda_device):
    """ModelNet's hard-family pool window at level 0 (2688 rows), the
    widest any config serves, on B=16 clouds of 10000 points: K2's
    rank and grouped-bin maps and K7 with the map."""
    cfgs = (modelnet_config(fast=True, dense=True, family="hard"),
            s3dis_config(fast=True, dense=True))
    window = max(c.pool_window(lv) for c in cfgs for lv in range(
        len(c.radius)))
    assert window == 2688
    pts = surface_clouds(np.random.default_rng(11), 16, 10000)
    pts = np.take_along_axis(pts, np.argsort(pts[..., :1], 1), 1)
    t = torch.from_numpy(pts).to(cuda_device)
    sub = t[:, ::4].contiguous()
    for db, q, kernel in ((t, sub, None), (t, t, KERNEL)):
        plan = D.plan_dense_query(db, q, 0.1, kernel, window)
        assert_query_equal((plan.db_p, plan.q_p, plan.s_blk, plan.u_end),
                           plan.axis, True, radius=0.1, k=64, kernel=kernel,
                           window=plan.window)
    plan = D.plan_dense_query(sub, t, 0.1, None, window, growth_steps=3)
    assert_growth_equal((plan.db_p, plan.q_p, plan.s_blk, plan.u_end), True,
                        radius=0.1, k=64, window=plan.window, growth_steps=3)
