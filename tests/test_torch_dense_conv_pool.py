"""PyTorch port vs JAX: dense depthwise conv, dense max pool and the
dense masked-mean unpool.

Both frameworks build their own dense graph from the same numpy-seeded
sorted clouds (the graphs are equal, see test_torch_dense_graph.py) and
run the same features, filters and pointwise kernels through it. JAX runs
its Pallas conv and rank-pool kernels in interpret mode on the CPU.

Tolerances: conv f32 rtol=atol=1e-5 (f32 sums in another order); conv
bf16 rtol=atol=3e-2 (one bf16 rounding of the conv output, and for
C_in > 128 the JAX row-major path rounds the unscaled sums to bf16 once
more before its scale); pool exact in f32 and bf16 (a max of the same
values); unpool f32 within 1e-6 (f32 sums of at most K terms in another
order), bf16 within one bf16 ulp of the reference (both round the f32
sum once, then scale in bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph3d_gcn_tpu.ops import dense as jd
from sph3d_gcn_torch.ops import dense as td

KERNEL = (8, 2, 2)
F_BINS = 33


def sorted_clouds(seed, b=2, n=600):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    for i in range(b):
        v[i] = v[i][np.argsort(v[i, :, (i + 1) % 3], kind="stable")]
    return v


def both_graphs(db, q, radius, k, kernel, window, self_graph):
    jg = jd.build_dense_graph(jnp.asarray(db), jnp.asarray(q), radius, k,
                              kernel, window=window, self_graph=self_graph)
    tg = td.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                              radius, k, kernel, window=window,
                              self_graph=self_graph)
    assert bool(jg.ok) == bool(tg.ok)
    return jg, tg


DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,mult", [(35, 2), (64, 1), (131, 1)])
def test_dense_conv_with_pointwise_fold(c_in, mult, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    pts = sorted_clouds(0)
    jg, tg = both_graphs(pts, pts, 0.2, 32, KERNEL, 384, True)
    rng = np.random.default_rng(c_in)
    feats = rng.standard_normal((2, 600, c_in)).astype(np.float32)
    filt = (rng.standard_normal((F_BINS, c_in, mult)) * 0.3).astype(np.float32)
    pw = (rng.standard_normal((c_in * mult, 48)) * 0.2).astype(np.float32)
    ref = jd.dense_depthwise_conv3d(jnp.asarray(feats, jdt), jnp.asarray(filt),
                                    jg, pointwise=jnp.asarray(pw))
    got = td.dense_depthwise_conv3d(torch.from_numpy(feats).to(tdt),
                                    torch.from_numpy(filt), tg,
                                    pointwise=torch.from_numpy(pw))
    assert got.dtype == tdt and got.shape == (2, 600, 48)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_dense_conv_without_fold_and_ungrouped_bins():
    # the conv alone (B, M, C*r), on a map the plain twin reads ungrouped
    pts = sorted_clouds(1)
    jg, tg = both_graphs(pts, pts, 0.2, 32, KERNEL, 384, True)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 600, 20)).astype(np.float32)
    filt = rng.standard_normal((F_BINS, 20, 2)).astype(np.float32)
    ref = jd.dense_depthwise_conv3d(jnp.asarray(feats), jnp.asarray(filt), jg)
    got = td.dense_depthwise_conv3d(torch.from_numpy(feats),
                                    torch.from_numpy(filt), tg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # un-grouping the ids and the filter rows gives the same conv
    perm = torch.tensor(td._grouped_perm(F_BINS))
    pk = tg.packed.long()
    ref_ids = torch.where(pk > 0, perm[tg.axis.long()][
        torch.arange(2)[:, None, None, None], (pk - 1).clamp(min=0)] + 1, 0)
    ug = td.DenseNeighborhood(
        packed=ref_ids.to(torch.int8), s_blk=tg.s_blk, count=tg.count,
        ok=tg.ok, num_query=tg.num_query, num_db=tg.num_db,
    )
    np.testing.assert_allclose(
        td.dense_depthwise_conv3d(torch.from_numpy(feats),
                                  torch.from_numpy(filt), ug).numpy(),
        got.numpy(), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 128, 512])
def test_dense_max_pool_rank_maps(c, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    pts = sorted_clouds(2)
    coarse = pts[:, ::4]
    jg, tg = both_graphs(pts, coarse, 0.2, 16, None, 512, False)
    rng = np.random.default_rng(c)
    feats = rng.standard_normal((2, 600, c)).astype(np.float32)
    feats[:, ::7] = -np.abs(feats[:, ::7])       # negative maxima too
    ref, _ = jd.dense_max_pool3d(jnp.asarray(feats, jdt), jg,
                                 with_index=False)
    got, idx = td.dense_max_pool3d(torch.from_numpy(feats).to(tdt), tg)
    assert idx is None and got.dtype == tdt and got.shape == (2, 150, c)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_dense_max_pool_empty_rows_give_zero():
    pts = sorted_clouds(3)
    far = pts[:, :50].copy()
    far[:, 25:, 0] += 9.0          # half the queries find no neighbor
    far = np.ascontiguousarray(far)
    tg = td.build_dense_graph(torch.from_numpy(pts), torch.from_numpy(far),
                              0.2, 16, None, window=640)
    feats = torch.randn(2, 600, 64, generator=torch.Generator().manual_seed(0))
    out, _ = td.dense_max_pool3d(feats - 10.0, tg)
    empty = tg.count == 0
    assert empty.any() and (~empty).any()
    assert (out[empty] == 0).all() and (out[~empty] < 0).all()
    # max_index: the input row holding each maximum; an empty row points
    # at its window's first row (JAX's column 0)
    out_i, idx = td.dense_max_pool3d(feats - 10.0, tg, with_index=True)
    assert torch.equal(out_i, out) and idx.dtype == torch.int32
    picked = torch.gather(feats - 10.0, 1, idx.long())
    assert torch.equal(picked[~empty], out[~empty])
    start = tg.s_blk.repeat_interleave(128, dim=1)[:, :50, None] * 128
    assert torch.equal(idx[empty].long(),
                       start.expand(-1, -1, 64)[empty].clamp(max=599))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [64, 256])
def test_dense_mean_interpolate_growth_graph(c, dtype):
    """Fine points unpool from a coarse subsequence through the decoder's
    inter graph, radius growth included."""
    jdt, tdt, _ = DTYPES[dtype]
    pts = sorted_clouds(4)
    coarse = np.ascontiguousarray(pts[:, ::6])
    jg = jd.build_dense_graph(jnp.asarray(coarse), jnp.asarray(pts), 0.06,
                              16, None, window=128, growth_steps=6)
    tg = td.build_dense_graph(torch.from_numpy(coarse), torch.from_numpy(pts),
                              0.06, 16, None, window=128, growth_steps=6)
    assert bool(jg.ok) and bool(tg.ok)
    rng = np.random.default_rng(c)
    feats = rng.standard_normal((2, 100, c)).astype(np.float32)
    ref = np.asarray(jd.dense_mean_interpolate(jnp.asarray(feats, jdt), jg),
                     np.float32)
    got = td.dense_mean_interpolate(torch.from_numpy(feats).to(tdt), tg)
    assert got.dtype == tdt and got.shape == (2, 600, c)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - ref) <= ulp).all()
    # rows with several neighbors really average
    assert int(tg.count.max()) > 1 and np.abs(got).max() > 0
