"""K9, the segment sum of the backward passes (``csrc/window_gather_bwd.cu``),
and its plain twins, on operands made with numpy from a seed.

Form (a), the per-edge engine's gather backward: ``dx[r] = sum of dg[e]``
over row r's inverse edge list, in list order. Form (b), the dense window
sums' backward (the unpools and the avg pool): the same sum over the
window columns that are cloud row r, each column's term ``sum over r
ascending of lhs[g, r, w] * dout[g * 128 + r]`` formed from the map (or
the weighted unpool's weights) as it goes. Both sum in f32 and round once.

On the CPU: both plain twins against a float64 numpy sum (within the
f32 summation bound stated below) and against numpy's float32 adds in
list order (bitwise), at C from 1 to 512 in f32 and bf16, with empty
rows, one-entry rows and a row of hundreds of entries; numpy models of
the kernel's lane groups (group size, vector width, slots, passes, rows a
warp, the list fetch) and of form (a)'s funnel-shift joins of aligned
chunks (every offset) covering every channel of every row exactly once;
the cost of a recorded dense backward (``ops.costs.call_costs``);
form (b) inside the dense unpools and the avg pool against JAX's VJP (JAX
imported inside those tests). Tests marked ``cuda`` hold the kernel to
the plain twins bitwise and skip where there is no card (run them there
with ``python -m pytest tests/test_torch_gather_bwd.py -m cuda
--noconftest``; they import no JAX).
"""

import functools

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import dense as D
from sph3d_gcn_torch.ops import windowed as W

TILE = 128
THREADS = 256      # the kernel's block (kThreads)
IN_FLIGHT = 4      # form (a)'s rows loaded before their adds (kInFlight)
CHANNELS = (1, 3, 35, 64, 67, 131, 259, 512)
DTYPES = (torch.float32, torch.bfloat16)
LHS = ("mask", "float32", "bfloat16")
LONG = 300         # the entries of the longest list


def _edge_operands(seed, c, batch=2, n=96, m_pad=256, k=4):
    """(dg f32 (B, M_pad, K, C), order, starts, N): edges with random
    target rows (a fifth invalid), cloud 0's row 5 taking LONG of them,
    rows 0-9 of cloud 1 empty, rows 10-19 of cloud 1 with one entry."""
    rng = np.random.default_rng(seed)
    rows = batch * n
    key = rng.integers(0, rows, batch * m_pad * k)
    key[rng.random(key.size) < 0.2] = rows               # invalid edges
    key[(key >= n + 0) & (key < n + 20)] = rows
    key[rng.choice(key.size, LONG, replace=False)] = 5
    key[rng.choice(np.flatnonzero(key == rows), 10, replace=False)] = (
        n + 10 + np.arange(10))
    order, starts = W.group_by_row(torch.from_numpy(key).to(torch.int32),
                                   rows)
    dg = rng.standard_normal((batch, m_pad, k, c)).astype(np.float32)
    return dg, order, starts, n


def _window_operands(seed, c, kind, batch=2, n_t=3, window=256, n=450):
    """(lhs (B, nT, 128, W): the int8 map (a few negative bytes, not
    selected) or f32 / bf16 weights, 0 off the selection; s_blk; dout f32;
    N) of window rows s_blk * 128 + w over clouds of N rows: a column of
    tile 0 selected in all 128 rows, a row of tile 1 in every column,
    window rows past the cloud and cloud rows in no window."""
    rng = np.random.default_rng(seed)
    sel = rng.random((batch, n_t, TILE, window)) < 0.04
    sel[0, 0, :, 7] = True
    sel[1, 1, 3, :] = True
    packed = np.where(sel, rng.integers(1, 20, sel.shape), 0)
    packed[rng.random(sel.shape) < 0.01] = -3
    s_blk = torch.tensor([[0, 1, 2], [0, 0, 1]])
    packed = torch.from_numpy(packed.astype(np.int8))
    if kind == "mask":
        lhs = packed
    else:
        wts = np.where(packed.numpy() > 0, rng.random(sel.shape), 0)
        lhs = torch.from_numpy(wts.astype(np.float32)).to(getattr(torch,
                                                                 kind))
    dout = torch.from_numpy(rng.standard_normal(
        (batch, n_t * TILE, c)).astype(np.float32))
    return lhs, s_blk, dout, n


def _numpy_terms(lhs, dout):
    """(float32 terms (G*W, C) in r order, float64 terms, |terms| bound
    sums): numpy's model of form (b)'s window column terms."""
    g, _, w = lhs.shape[0] * lhs.shape[1], lhs.shape[2], lhs.shape[3]
    c = dout.shape[-1]
    if lhs.dtype == torch.int8:
        sel = lhs.numpy() > 0
        fac = sel.astype(np.float32)
    else:
        fac = lhs.float().numpy()
        sel = fac != 0
    sel = sel.reshape(g, TILE, w)
    fac = fac.reshape(g, TILE, w)
    d = dout.numpy().reshape(g, TILE, c)
    t32 = np.zeros((g, w, c), np.float32)
    mags = np.zeros((g, w, c), np.float64)
    for r in range(TILE):
        prod = (fac[:, r, :, None] * d[:, r, None, :]).astype(np.float32)
        t32 = np.where(sel[:, r, :, None], t32 + prod, t32)
        mags += np.where(sel[:, r, :, None], np.abs(prod), 0)
    t64 = np.einsum("gtw,gtc->gwc", np.where(sel, fac, 0).astype(np.float64),
                    d.astype(np.float64))
    return t32.reshape(g * w, c), t64.reshape(g * w, c), mags.reshape(
        g * w, c)


def _numpy_list_sum(src, order, starts, dtype):
    """numpy's list-order sum of ``src[order[i]]`` per row: in ``dtype``
    (each add rounded), one step adding every row's i-th entry."""
    order, starts = order.numpy(), starts.numpy().astype(np.int64)
    length = np.diff(starts)
    out = np.zeros((length.size, src.shape[-1]), dtype)
    for i in range(int(length.max())):
        live = np.flatnonzero(length > i)
        out[live] = out[live] + src[order[starts[live] + i]].astype(dtype)
    return out, length


def _sum_bound(mags, length):
    """The f32 summation bound of a list sum against its exact value:
    (entries - 1) * 2^-24 * the summed magnitudes, per row."""
    return np.maximum(length - 1, 0)[:, None] * 2.0 ** -24 * mags


# ------------------------------------------------------------- form (a)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", CHANNELS)
def test_gather_bwd_plain_matches_numpy(c, dtype):
    """Form (a)'s plain twin: bitwise numpy's float32 adds in list order
    (rounded once to bf16), and within the f32 summation bound (plus one
    bf16 rounding) of the float64 sum."""
    dg, order, starts, n = _edge_operands(c, c)
    x = torch.from_numpy(dg).to(dtype)
    got = W.window_gather_bwd_plain(x, order, starts, n)
    assert got.dtype == dtype and got.shape == (2, n, c)
    src = x.float().numpy().reshape(-1, c)
    ref32, length = _numpy_list_sum(src, order, starts, np.float32)
    assert length.max() >= LONG and (length == 0).sum() >= 10
    assert (length == 1).sum() >= 10
    assert torch.equal(got, torch.from_numpy(ref32).to(dtype).reshape(
        got.shape))
    ref64, _ = _numpy_list_sum(src, order, starts, np.float64)
    mags, _ = _numpy_list_sum(np.abs(src), order, starts, np.float64)
    err = np.abs(got.float().numpy().reshape(ref64.shape) - ref64)
    tol = _sum_bound(mags, length)
    if dtype == torch.bfloat16:                # and one bf16 rounding
        tol = tol + 2.0 ** -8 * (np.abs(ref64) + tol)
    assert (err <= tol).all()


# ------------------------------------------------------------- form (b)


@pytest.mark.parametrize("kind", LHS)
@pytest.mark.parametrize("c", CHANNELS)
def test_window_sum_bwd_plain_matches_numpy(c, kind):
    """Form (b)'s plain twin (f32 out): bitwise numpy's float32 model
    (each column's products and adds in r order, then the terms in the
    order of the window rows' lists), and within the f32 summation bound
    of the float64 sum."""
    lhs, s_blk, dout, n = _window_operands(c, c, kind)
    got = W.window_sum_bwd_plain(lhs, s_blk, dout, n)
    order, starts = W.window_lists(s_blk, lhs.shape[-1], n)
    assert got.dtype == torch.float32 and got.shape == (2, n, c)
    t32, t64, mags = _numpy_terms(lhs, dout)
    ref32, length = _numpy_list_sum(t32, order, starts, np.float32)
    np.testing.assert_array_equal(got.numpy().reshape(ref32.shape), ref32)
    ref64, _ = _numpy_list_sum(t64, order, starts, np.float64)
    row_mags, _ = _numpy_list_sum(mags, order, starts, np.float64)
    # a term of j entries is itself within (j - 1) * 2^-24 of its sum
    err = np.abs(got.numpy().reshape(ref64.shape) - ref64)
    assert (err <= _sum_bound(row_mags, length) + TILE * 2.0 ** -24
            * row_mags).all()
    assert length.max() >= 2 and (length == 0).any()


def test_window_lists_order_each_row_by_tile():
    """Each cloud row's window rows, in ascending tile: the order K9's
    form (b) walks its tiles in."""
    _, s_blk, _, n = _window_operands(1, 8, "mask")
    order, starts = W.window_lists(s_blk, 256, n)
    sb = s_blk.numpy()
    for b in range(2):
        for row in range(n):
            at = b * n + row
            got = order[starts[at]:starts[at + 1]].numpy()
            tiles = [g for g in range(3) if 0 <= row - 128 * sb[b, g] < 256]
            assert got.tolist() == [(b * 3 + g) * 256 + row - 128 * sb[b, g]
                                    for g in tiles]


def test_window_mean_bwd_plain_is_form_b():
    """The dense backward hands K9 the map or the weights, s_blk and
    ``dout``: no window gradients are formed beforehand."""
    lhs, s_blk, dout, n = _window_operands(1, 8, "float32")
    packed = (lhs > 0).to(torch.int8)
    assert torch.equal(D.window_mean_bwd(packed, s_blk, dout, n, lhs),
                       W.window_sum_bwd_plain(lhs, s_blk, dout, n))
    assert torch.equal(D.window_mean_bwd(packed, s_blk, dout, n),
                       W.window_sum_bwd_plain(packed, s_blk, dout, n))


def test_kernels_take_no_cpu_tensors():
    lhs, s_blk, dout, n = _window_operands(2, 4, "mask")
    with pytest.raises(ValueError, match="CUDA"):
        W.window_sum_bwd_kernel(lhs, s_blk, dout, n)
    dg, order, starts, n = _edge_operands(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        W.window_gather_bwd_kernel(torch.from_numpy(dg), order, starts, n)


# ----------------------------------------------------- lane-group model


def _row_cover(c, elem, align, rows):
    """numpy model of the kernel's grid over ``rows`` rows: which
    (row, byte) each live (thread, pass, slot) vector covers. Returns
    (cover counts (rows, C * elem), layout, idle lanes in some pass)."""
    group, vec, slots, passes = W.gather_bwd_layout(c, elem, align)
    log_g = group.bit_length() - 1
    nv = c * elem // vec
    blocks = -(-(rows << log_g) // THREADS)
    t = np.arange(blocks * THREADS)
    row, lg = t >> log_g, t & (group - 1)
    t, row, lg = t[row < rows], row[row < rows], lg[row < rows]
    cover = np.zeros((rows, c * elem), np.int64)
    idle = 0
    for p in range(passes):
        live_any = np.zeros(t.size, bool)
        for j in range(slots):
            v = lg + group * (p + passes * j)
            live = v < nv
            live_any |= live
            for b in range(vec):
                np.add.at(cover, (row[live], v[live] * vec + b), 1)
        idle += int((~live_any).sum())
    return cover, (group, vec, slots, passes), idle


def _passes(row, vec, group):
    """(slots, passes) of vectors of ``vec`` bytes over ``group`` lanes: the
    fewest passes whose slots fit a lane, the slots balanced."""
    most = min(W.GATHER_BWD_MAX_SLOTS, W.GATHER_BWD_LANE_BYTES // vec)
    per_lane = -(-(row // vec) // group)
    passes = -(-per_lane // most)
    return -(-per_lane // passes), passes


@pytest.mark.parametrize("elem", (4, 2))
def test_lane_groups_cover_every_channel_once(elem):
    """Every channel of every row exactly once, for C from 1 to 600 at
    each address alignment, and no lane idle in any pass; the vector the
    widest that the row and the address allow and that idles no lane, the
    group the largest power of two, at most 32, that the row's vectors
    fill (a row of 2^k 16-byte vectors: the smallest group covering it),
    at most 16 bytes (3 vectors) a lane a pass."""
    for c in list(range(1, 80)) + [127, 128, 131, 255, 256, 259, 300, 511,
                                   512, 513, 600]:
        for align in (16, 8, 4, 2):
            if align < elem:
                continue
            cover, (group, vec, slots, passes), idle = _row_cover(
                c, elem, align, 3)
            row = c * elem
            assert (cover == 1).all(), (c, align)
            assert idle == 0, (c, align)
            nv = row // vec
            assert group in (1, 2, 4, 8, 16, 32)
            assert group <= nv and (group == 32 or 2 * group > nv)
            if vec == 16 and nv & (nv - 1) == 0 and nv <= 32:
                assert group * 16 >= row > group * 8 or row == 16
            assert row % vec == 0 and align % vec == 0 and vec >= elem
            assert (slots, passes) == _passes(row, vec, group)
            assert slots * vec <= W.GATHER_BWD_LANE_BYTES
            assert slots <= W.GATHER_BWD_MAX_SLOTS
            for wider in (16, 8, 4):
                if wider > vec and row % wider == 0 and align % wider == 0:
                    # a wider vector would idle the group's last lane
                    g = min(32, 1 << ((row // wider).bit_length() - 1))
                    assert g * _passes(row, wider, g)[1] > row // wider, (
                        c, align, wider)


def test_lane_groups_rows_a_warp_and_list_fetch():
    """A warp owns 32 / group consecutive rows (a block 256 / group); a
    group's fetches of ``group`` list entries, a lane each, hand every
    entry out once, entry i from lane i % group, 8 at a time."""
    for c, elem in ((1, 4), (3, 4), (35, 2), (64, 4), (131, 4), (512, 2)):
        group = W.gather_bwd_layout(c, elem)[0]
        log_g = group.bit_length() - 1
        row = np.arange(THREADS) >> log_g
        for warp in range(THREADS // 32):
            rows = np.unique(row[warp * 32:(warp + 1) * 32])
            assert rows.tolist() == list(range(rows[0], rows[0] + 32
                                               // group))
        for length in (0, 1, 7, 8, 9, group, 3 * group + 5, 300):
            seen = []
            for base in range(0, length, group):
                held = {lane: base + lane for lane in range(group)
                        if base + lane < length}
                n = min(group, length - base)
                for c0 in range(0, n, IN_FLIGHT):
                    for q in range(min(IN_FLIGHT, n - c0)):
                        seen.append(held[(c0 + q) & (group - 1)])
            assert seen == list(range(length))


def _join(own: bytes, nxt: bytes, shift: int) -> bytes:
    """The kernel's join of two aligned 16-byte chunks at byte ``shift``:
    eight little-endian words, two select stages by whole words, then a
    32-bit funnel shift right by the rest."""
    w = [int.from_bytes((own + nxt)[4 * i:4 * i + 4], "little")
         for i in range(8)]
    k, h = shift >> 2, 8 * (shift & 3)
    for i in range(6):
        w[i] = w[i + 2] if k & 2 else w[i]
    for i in range(5):
        w[i] = w[i + 1] if k & 1 else w[i]
    out = [((w[i + 1] << 32 | w[i]) >> h) & 0xFFFFFFFF for i in range(4)]
    return b"".join(x.to_bytes(4, "little") for x in out)


@pytest.mark.parametrize("elem", (4, 2))
def test_funnel_lanes_join_every_channel_once(elem):
    """Form (a) on rows off whole aligned 16-byte vectors: at every offset
    of the edge's row in its aligned chunk, each output chunk is owned by
    exactly one (pass, slot, lane), and joining the lane's aligned chunk
    to the next lane's, as the kernel does, gives the row's bytes; every
    lane but a group's last owns a chunk in every pass; the group the
    largest power of two whose first unit it fills, at most 2 chunks a
    lane a pass."""
    rng = np.random.default_rng(elem)
    for c in list(range(1, 80)) + [127, 131, 255, 259, 300, 513, 600]:
        row = c * elem
        group, slots, passes = W.funnel_layout(c, elem)
        chunks = -(-row // 16)
        assert group in (2, 4, 8, 16, 32) and group - 1 <= max(chunks, 1)
        assert group == 32 or 2 * group - 1 > chunks
        assert slots <= W.FUNNEL_SLOTS
        assert (group - 1) * slots * passes >= chunks
        data = rng.integers(0, 256, row, dtype=np.uint8).tobytes()
        for shift in range(0, 16, elem):
            held = -(-(shift + row) // 16)
            mem = bytes(shift) + data + bytes(16 * held - shift - row)
            got = bytearray(row)
            cover = np.zeros(chunks, np.int64)
            for p in range(passes):
                owners = set()
                for j in range(slots):
                    unit = p + passes * j
                    lanes = [unit * (group - 1) + lane
                             for lane in range(group)]
                    loaded = [mem[16 * k:16 * k + 16] if k < held
                              else bytes(16) for k in lanes]
                    for lane, k in enumerate(lanes[:-1]):
                        if k >= chunks:
                            continue
                        owners.add(lane)
                        cover[k] += 1
                        out = _join(loaded[lane], loaded[lane + 1], shift)
                        n = min(16, row - 16 * k)
                        got[16 * k:16 * k + n] = out[:n]
                assert owners == set(range(group - 1)) or chunks < group - 1
            assert (cover == 1).all(), (c, shift)
            assert bytes(got) == data, (c, shift)


# ---------------------------------------------------- form (b) vs JAX


def _sorted_clouds(seed, b=2, n=384):
    """Ellipsoid surfaces, cloud i sorted along axis (i + 1) % 3."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0.3, 1.0, (b, 1, 3)).astype(np.float32)
    for i in range(b):
        v[i] = v[i][np.argsort(v[i, :, (i + 1) % 3], kind="stable")]
    return v


@functools.lru_cache(maxsize=None)
def _graphs(name):
    """(JAX graph, port graph): "unpool", fine rows from every fifth row
    with growth and distance maps; "pool", every fourth row's ranks."""
    import jax
    import jax.numpy as jnp

    from sph3d_gcn_tpu.ops import dense as jd

    p = _sorted_clouds(4)
    if name == "unpool":
        db, q, r, k, w, steps = np.ascontiguousarray(p[:, ::5]), p, 0.08, \
            8, 128, 6
    else:
        db, q, r, k, w, steps = p, np.ascontiguousarray(p[:, ::4]), 0.2, \
            16, 384, 0
    jg = jax.jit(lambda d, e: jd.build_dense_graph(
        d, e, r, k, None, window=w, need_dist=True,
        growth_steps=steps))(jnp.asarray(db), jnp.asarray(q))
    tg = D.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q), r,
                             k, None, window=w, need_dist=True,
                             growth_steps=steps)
    return jg, tg, db.shape[1], q.shape[1]


# as tests/test_torch_dist_maps.py states them: f32, the window gradients
# summed into the cloud in another order than XLA's; bf16, the outputs
# and gradients rounded once to bf16 on both sides (one bf16 ulp, 2^-8 of
# the value, where the f32 sums straddle a rounding boundary)
OP_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
OPS = {"mean_interpolate": ("unpool", "dense_mean_interpolate"),
       "weighted_interpolate": ("unpool", "dense_weighted_interpolate"),
       "avg_pool": ("pool", "dense_avg_pool3d")}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("op", sorted(OPS))
def test_window_sum_backward_matches_jax_vjp(op, dtype):
    """The dense unpools' and the avg pool's gradient in ``inputs``, whose
    backward is K9's form (b) (its plain twin on the CPU), against JAX's
    VJP of the same op on the same graph; the forward too."""
    import jax
    import jax.numpy as jnp

    from sph3d_gcn_tpu.ops import dense as jd

    graph, fn = OPS[op]
    jg, tg, n_in, m = _graphs(graph)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(21)
    feats = rng.standard_normal((2, n_in, 48)).astype(np.float32)
    cot = rng.standard_normal((2, m, 48)).astype(np.float32)

    def run(f):
        out, vjp = jax.vjp(lambda v: getattr(jd, fn)(v, jg), f)
        return out, vjp(jnp.asarray(cot).astype(out.dtype))[0]

    ref, ref_g = (np.asarray(a, np.float32) for a in jax.jit(run)(
        jnp.asarray(feats, jdt)))
    x = torch.from_numpy(feats).to(dtype).requires_grad_()
    out = getattr(D, fn)(x, tg)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert out.dtype == dtype and x.grad.dtype == dtype
    tol = OP_TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=tol,
                               atol=tol)
    got_g = x.grad.float().numpy()
    np.testing.assert_allclose(got_g, ref_g, rtol=tol,
                               atol=tol * np.abs(ref_g).max())
    assert np.abs(got_g).max() > 0


@pytest.mark.parametrize("op", sorted(OPS))
def test_call_costs_count_form_b(op):
    """A recorded dense window sum's backward is costed as the K9 launch
    it makes, on its own operands: the map or the weights, s_blk and
    ``dout`` read once, dx written in f32, a product and an add per
    selected entry and channel (``ops.costs.call_costs``, as
    ``cli.profile_step`` sums a step's calls)."""
    from sph3d_gcn_torch import _build
    from sph3d_gcn_torch.ops import costs

    graph, fn = OPS[op]
    p = _sorted_clouds(4)
    if graph == "unpool":
        db, q = np.ascontiguousarray(p[:, ::5]), p
        tg = D.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                                 0.08, 8, None, window=128, need_dist=True,
                                 growth_steps=6)
    else:
        db, q = p, np.ascontiguousarray(p[:, ::4])
        tg = D.build_dense_graph(torch.from_numpy(db), torch.from_numpy(q),
                                 0.2, 16, None, window=384)
    c = 24
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, db.shape[1], c)).astype(np.float32)).requires_grad_()
    with _build.record_calls() as calls:
        getattr(D, fn)(x, tg).sum().backward()
    (bwd,) = [(a, kw) for name, a, kw in calls
              if name == "mean_interpolate_bwd"]
    (packed, s_blk, dout, n), kw = bwd
    lhs = kw.get("weights", packed)
    assert (lhs is packed) == (op != "weighted_interpolate")
    sel = int((lhs > 0 if lhs.dtype == torch.int8 else lhs != 0).sum())
    got = costs.call_costs(calls)
    assert set(got) == {"window_gather_bwd"}
    k9 = got["window_gather_bwd"]
    assert k9["calls"] == 1 and sel > 0
    assert k9["bytes"] == (lhs.numel() * lhs.element_size()
                           + s_blk.numel() * s_blk.element_size()
                           + dout.numel() * 4 + 2 * n * c * 4)
    assert k9["operations"] == 2 * sel * c
    assert k9["bound_by"] == "bytes"


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` copied to ``offset`` elements past its storage's start."""
    flat = torch.cat([x.reshape(-1)[:offset], x.reshape(-1)])
    return flat[offset:].view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_gather_bwd_kernel_matches_plain_on_cuda(cuda_device, dtype):
    """Form (a) bitwise equal to its plain twin and to itself at every
    width, with the gradients in place and 1 or 3 elements past their
    storage's start."""
    for c in CHANNELS:
        dg, order, starts, n = _edge_operands(c, c)
        x = torch.from_numpy(dg).to(dtype).to(cuda_device)
        order, starts = order.to(cuda_device), starts.to(cuda_device)
        ref = W.window_gather_bwd_plain(x, order, starts, n)
        for offset in (0, 1, 3):
            xs = _offset(x, offset)
            got = W.window_gather_bwd_kernel(xs, order, starts, n)
            assert torch.equal(got, ref), (c, offset)
            assert torch.equal(got, W.window_gather_bwd_kernel(
                xs, order, starts, n))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LHS)
def test_window_sum_bwd_kernel_matches_plain_on_cuda(cuda_device, kind):
    """Form (b) bitwise equal to its plain twin and to itself at every
    width, with ``dout`` in place and 1 or 3 elements past its storage's
    start."""
    for c in CHANNELS:
        ops = _window_operands(c, c, kind)
        lhs, s_blk, dout = (t.to(cuda_device) for t in ops[:3])
        n = ops[3]
        ref = W.window_sum_bwd_plain(lhs, s_blk, dout, n)
        for offset in (0, 1, 3):
            ds = _offset(dout, offset)
            got = W.window_sum_bwd_kernel(lhs, s_blk, ds, n)
            assert torch.equal(got, ref), (c, offset)
            assert torch.equal(got, W.window_sum_bwd_kernel(
                lhs, s_blk, ds, n))
