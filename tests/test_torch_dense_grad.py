"""PyTorch port vs JAX: gradients of the dense conv, the dense max pool
(also with ``max_index``), the masked-mean unpool and the logits unsort.

Both frameworks build their own dense graph from the same numpy-seeded
sorted clouds (equal graphs, see test_torch_dense_graph.py) and
differentiate ``sum(out * cot)`` for the same numpy cotangent. JAX runs
its Pallas forward and backward kernels in interpret mode on the CPU; the
port runs its plain backward versions (the CUDA kernels K5 and K6 are
held against these on the card, test_torch_dispatch.py).

Tolerances, as the relative L2 error of each gradient
(``|got - ref| / |ref|``):

- conv f32: 1e-5 (f32 sums in other orders);
- conv bf16: 2e-2 for ``inputs`` and ``pointwise``, 3e-2 for the filter.
  The JAX backward stashes the bin sums S and stages dS in bf16, emits
  each tile's window gradient in bf16 before summing the tiles, and
  rounds the per-cloud filter gradient to bf16; the port sums in f32 and
  rounds ``dx`` once. The difference is bf16 rounding (2^-8 relative) on
  sums of a few tens of terms.
- pool f32 and bf16: exact. The features are small integers (so maxima
  tie often, -0 and +0 among them) and the cotangent is integer too, so
  every sum is exact in both frameworks and the routing alone is
  compared: all of a row's gradient to its first attaining neighbor,
  nothing from an empty row. ``max_index`` and the values with it:
  exact (a max of the same values; ids from the same first column).
- unpool f32: 1e-6 of the largest gradient magnitude (f32 sums of a few
  terms in another order); bf16: relative L2 2e-2 (JAX rounds each
  tile's window gradient to bf16 and adds the tiles in bf16, the port
  sums in f32 and rounds once). The unsort: exact (a permutation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import dense as jd
from sph3d_gcn_tpu.ops import locality as jl
from sph3d_gcn_torch.ops import dense as td
from sph3d_gcn_torch.ops import locality as tl
from test_torch_dense_conv_pool import both_graphs, sorted_clouds

KERNEL = (8, 2, 2)
F_BINS = 33
N = 600


def rel_err(got: torch.Tensor, ref) -> float:
    ref = torch.from_numpy(np.array(ref, np.float32))
    return float((got.float() - ref).norm() / ref.norm())


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,mult", [(35, 1), (35, 2), (64, 1), (64, 2),
                                       (131, 1), (131, 2), (512, 2),
                                       (1024, 2)])
def test_dense_conv_grads_match_jax(c_in, mult, dtype):
    """Gradients in ``inputs``, ``filt`` and ``pointwise`` of the conv
    with its pointwise fold, on grouped bin maps; C_in = 131, 512 and
    1024 (the S3DIS decoder's widest) are the JAX package's row-major
    kernel pair (#7/#8), the port's plain version of K5 in its wide
    chunks' range."""
    _check_conv_grads(c_in, mult, dtype)


def _check_conv_grads(c_in, mult, dtype, n=N):
    jdt, tdt = DTYPES[dtype]
    tol_x, tol_f = CONV_TOL[dtype]
    pts = sorted_clouds(0, n=n)
    jg, tg = both_graphs(pts, pts, 0.2, 32, KERNEL, 384, True)
    assert tg.grouped
    rng = np.random.default_rng(c_in * 10 + mult)
    feats = rng.standard_normal((2, n, c_in)).astype(np.float32)
    filt = (rng.standard_normal((F_BINS, c_in, mult)) * 0.3).astype(np.float32)
    pw = (rng.standard_normal((c_in * mult, 48)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((2, n, 48)).astype(np.float32)

    def jloss(x, f, p):
        out = jd.dense_depthwise_conv3d(x, f, jg, pointwise=p)
        return jnp.sum(out.astype(jnp.float32) * cot)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(feats, jdt), jnp.asarray(filt), jnp.asarray(pw))

    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    f = torch.from_numpy(filt).requires_grad_()
    p = torch.from_numpy(pw).requires_grad_()
    out = td.dense_depthwise_conv3d(x, f, tg, pointwise=p)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == tdt and f.grad.dtype == torch.float32
    assert rel_err(x.grad, ref[0]) < tol_x
    assert rel_err(f.grad, ref[1]) < tol_f
    assert rel_err(p.grad, ref[2]) < tol_x


def test_dense_conv_grads_ungrouped_map():
    """Un-grouping the map's bin ids (the broadcast filter path) gives the
    same gradients as the sort-grouped map with its per-cloud filter rows
    (f32, 1e-5)."""
    pts = sorted_clouds(1)
    tg = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(pts),
                              0.2, 32, KERNEL, window=384, self_graph=True)
    perm = torch.tensor(td._grouped_perm(F_BINS))
    pk = tg.packed.long()
    ref_ids = torch.where(pk > 0, perm[tg.axis.long()][
        torch.arange(2)[:, None, None, None], (pk - 1).clamp(min=0)] + 1, 0)
    ug = td.DenseNeighborhood(
        packed=ref_ids.to(torch.int8), s_blk=tg.s_blk, count=tg.count,
        ok=tg.ok, num_query=tg.num_query, num_db=tg.num_db,
    )
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((2, N, 20)).astype(
        np.float32))
    filt = torch.from_numpy(rng.standard_normal((F_BINS, 20, 2)).astype(
        np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, N, 40)).astype(
        np.float32))
    grads = []
    for g in (tg, ug):
        x = feats.clone().requires_grad_()
        f = filt.clone().requires_grad_()
        (td.dense_depthwise_conv3d(x, f, g) * cot).sum().backward()
        grads.append((x.grad, f.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _pool_case(c, seed):
    """A sorted cloud, coarse queries of which every 5th is moved far away
    (empty rows), integer features with +0 and -0, integer cotangents."""
    pts = sorted_clouds(seed)
    q = pts[:, ::4].copy()
    q[:, ::5, 0] += 9.0          # off the sort axes: q stays sorted
    rng = np.random.default_rng(seed + c)
    feats = rng.integers(-3, 4, (2, N, c)).astype(np.float32)
    zeros = feats == 0
    feats[zeros & (rng.random(feats.shape) < 0.5)] = -0.0
    cot = rng.integers(-4, 5, (2, q.shape[1], c)).astype(np.float32)
    return pts, np.ascontiguousarray(q), feats, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 128, 512])
def test_dense_max_pool_grads_match_jax(c, dtype):
    """bf16 at C 64/128/512 is the JAX rank path (#12/#13; 512 is the
    S3DIS encoder's widest pool, the port's K6 in two channel chunks);
    f32 its XLA masked max. Both route a row's gradient to the first
    maximal neighbor."""
    jdt, tdt = DTYPES[dtype]
    pts, q, feats, cot = _pool_case(c, 2)
    jg, tg = both_graphs(pts, q, 0.2, 16, None, 512, False)
    assert not bool(tg.ok) and (tg.count == 0).any()      # empty rows
    ref = jax.grad(lambda a: jnp.sum(
        jd.dense_max_pool3d(a, jg, with_index=False)[0].astype(jnp.float32)
        * cot))(jnp.asarray(feats, jdt))
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    out, _ = td.dense_max_pool3d(x, tg)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == tdt
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert (x.grad != 0).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rank_pool_arg_is_first_attaining_column(dtype):
    """``arg`` of the plain pool: the first selected window column that
    attains the max, with -0 and +0 tied; -1 on empty rows; and the
    values equal the values-only launch."""
    pts, q, feats, _ = _pool_case(64, 3)
    tg = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(q),
                              0.2, 16, None, window=512)
    x = torch.from_numpy(feats).to(dtype)
    args = (tg.packed, tg.s_blk, td.pool_counts(tg), x)
    out, arg = td.rank_pool_plain(*args, with_arg=True)
    assert torch.equal(out, td.rank_pool_plain(*args))
    b, n_t, _, w = tg.packed.shape
    pk = tg.packed.reshape(b, n_t * 128, w).long()
    cnt = td.pool_counts(tg)
    rows = tg.s_blk.repeat_interleave(128, dim=1)[..., None] * 128 + \
        torch.arange(w)
    for bi, t in [(0, 0), (0, 5), (1, 17), (1, 30), (0, q.shape[1] - 1)]:
        sel = (pk[bi, t] >= 1) & (pk[bi, t] <= cnt[bi, t])
        cols = torch.nonzero(sel)[:, 0]
        if len(cols) == 0:
            assert (arg[bi, t] == -1).all() and (out[bi, t] == 0).all()
            continue
        vals = x[bi, rows[bi, t, cols]].float()             # (k, C)
        best = vals.max(dim=0).values
        first = torch.argmax((vals == best).to(torch.uint8), dim=0)
        assert torch.equal(arg[bi, t].long(), cols[first])
        assert torch.equal(out[bi, t].float(), best + 0.0)
    assert (arg == -1).any() and (arg >= 0).any()


def _distinct_feats(rng, n, c):
    """(2, n, c) features whose values are distinct within each channel
    and exact in bf16: no two window candidates tie."""
    mant = np.arange(128, dtype=np.float32) / 128.0 + 1.0
    vals = np.concatenate([s * (2.0 ** e) * mant for s in (-1, 1)
                           for e in range(-3, 4)]).astype(np.float32)
    return np.stack([np.stack([rng.choice(vals, n, replace=False)
                               for _ in range(c)], -1) for _ in range(2)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("maps", ["ranks", "bins"])
def test_dense_max_pool_with_index_matches_jax(maps, c, dtype):
    """``dense_max_pool3d(with_index=True)``: values and ``max_index``
    equal to JAX's (empty rows too: value 0, the window's first row), and
    the gradient equal to ``jax.vjp``'s on tie-free features. In bf16 at
    C 64/128 JAX runs its whole-window masked-max kernels (#10/#11), the
    port its pool kernel's plain version with the first attaining column
    (K4) and the pool backward's (K6); in f32 JAX's XLA masked max. Rank
    maps: a pool graph with empty rows; bin maps: a conv graph, where
    every nonzero entry is selected."""
    jdt, tdt = DTYPES[dtype]
    pts, q, _, _ = _pool_case(c, 4)
    rng = np.random.default_rng(c + 1)
    feats = _distinct_feats(rng, N, c)
    if maps == "ranks":
        jg, tg = both_graphs(pts, q, 0.2, 16, None, 512, False)
        assert (tg.count == 0).any()
    else:
        jg, tg = both_graphs(pts, pts, 0.2, 32, KERNEL, 384, True)
        assert tg.k_max == 0
    cot = rng.integers(-4, 5, (2, tg.num_query, c)).astype(np.float32)
    (ref, ref_idx), vjp = jax.vjp(
        lambda a: jd.dense_max_pool3d(a, jg, with_index=True),
        jnp.asarray(feats, jdt))
    (ref_dx,) = vjp((jnp.asarray(cot, jdt),
                     np.zeros(ref_idx.shape, jax.dtypes.float0)))
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    out, idx = td.dense_max_pool3d(x, tg, with_index=True)
    assert out.dtype == tdt and idx.dtype == torch.int32
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(ref_dx, np.float32))
    with torch.no_grad():                 # the inference launch
        out_i, idx_i = td.dense_max_pool3d(x, tg, with_index=True)
    assert torch.equal(out_i, out.detach()) and torch.equal(idx_i, idx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in", [64, 131])
def test_dense_conv_grads_match_jax_recompute(c_in, dtype, monkeypatch):
    """The port's conv gradient against the JAX backward that recomputes
    the bin sums S instead of stashing them (``_S_STASH_MAX_CC`` = 0):
    #6 at C_in = 64, #9 at C_in = 131. The port's K5 forms S from ``x``
    inside the backward in every case; tolerances as the stash test."""
    monkeypatch.setattr(jd, "_S_STASH_MAX_CC", 0)
    jd._dense_conv_for.cache_clear()
    jd._dense_conv_rm_for.cache_clear()
    try:
        _check_conv_grads(c_in, 2, dtype, n=384)
    finally:
        jd._dense_conv_for.cache_clear()
        jd._dense_conv_rm_for.cache_clear()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 256])
def test_dense_mean_interpolate_grad_matches_jax(c, dtype):
    """The unpool's gradient in ``inputs`` through the decoder's inter
    graph, radius growth included, against ``jax.vjp``."""
    jdt, tdt = DTYPES[dtype]
    pts = sorted_clouds(4)
    coarse = np.ascontiguousarray(pts[:, ::6])
    jg = jd.build_dense_graph(jnp.asarray(coarse), jnp.asarray(pts), 0.06,
                              16, None, window=128, growth_steps=6)
    tg = td.build_dense_graph(torch.from_numpy(coarse), torch.from_numpy(pts),
                              0.06, 16, None, window=128, growth_steps=6)
    rng = np.random.default_rng(c + 2)
    feats = rng.standard_normal((2, 100, c)).astype(np.float32)
    cot = rng.standard_normal((2, N, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jd.dense_mean_interpolate(a, jg),
                     jnp.asarray(feats, jdt))
    (ref,) = vjp(jnp.asarray(cot, jdt))
    x = torch.from_numpy(feats).to(tdt).requires_grad_()
    with td._build.record_calls() as calls:
        out = td.dense_mean_interpolate(x, tg)
        out.backward(torch.from_numpy(cot).to(tdt))
    assert [name for name, _, _ in calls] == ["mean_interpolate",
                                              "mean_interpolate_bwd"]
    assert x.grad.dtype == tdt
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
    else:
        assert rel_err(x.grad, ref) < 2e-2
    # the window gradients of overlapping tiles really were summed
    assert (tg.s_blk[:, 1:] == tg.s_blk[:, :-1]).any()


def test_permute_points_inv_grad_is_a_gather():
    """The unsort with ``inv``: forward and gradient equal to JAX's
    (exact), and no scatter in its backward."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 50, 13)).astype(np.float32)
    cot = rng.standard_normal((2, 50, 13)).astype(np.float32)
    perm = np.stack([rng.permutation(50) for _ in range(2)])
    rank = np.argsort(perm, axis=1)
    ref, vjp = jax.vjp(lambda a: jl.permute_points(
        a, jnp.asarray(rank), inv=jnp.asarray(perm)), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    out = tl.permute_points(xt, torch.from_numpy(rank),
                            inv=torch.from_numpy(perm))
    assert type(out.grad_fn).__name__ == "_PermuteBackward"
    out.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_dx))
