"""PyTorch port vs JAX: gradients of the dense conv and the dense max pool.

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
  nothing from an empty row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import dense as jd
from sph3d_gcn_torch.ops import dense as td
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
                                       (131, 1), (131, 2)])
def test_dense_conv_grads_match_jax(c_in, mult, dtype):
    """Gradients in ``inputs``, ``filt`` and ``pointwise`` of the conv
    with its pointwise fold, on grouped bin maps; C_in = 131 is the JAX
    package's row-major kernel pair (#7/#8)."""
    jdt, tdt = DTYPES[dtype]
    tol_x, tol_f = CONV_TOL[dtype]
    pts = sorted_clouds(0)
    jg, tg = both_graphs(pts, pts, 0.2, 32, KERNEL, 384, True)
    assert tg.grouped
    rng = np.random.default_rng(c_in * 10 + mult)
    feats = rng.standard_normal((2, N, c_in)).astype(np.float32)
    filt = (rng.standard_normal((F_BINS, c_in, mult)) * 0.3).astype(np.float32)
    pw = (rng.standard_normal((c_in * mult, 48)) * 0.2).astype(np.float32)
    cot = rng.standard_normal((2, N, 48)).astype(np.float32)

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
@pytest.mark.parametrize("c", [64, 128])
def test_dense_max_pool_grads_match_jax(c, dtype):
    """bf16 at C 64/128 is the JAX rank path (#12/#13); f32 its XLA
    masked max. Both route a row's gradient to the first maximal
    neighbor."""
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
