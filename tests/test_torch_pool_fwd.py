"""The dense max pool's forward (``csrc/rank_pool.cu``, K4) and its plain
version, with the first attaining column (``arg``) and the op-level
``max_index``, on operands made with numpy from a seed.

The maps are rank maps (ranks 1..r in window order on random columns,
capped at K as the query caps them, with a rank bound ``count`` per row)
and bin maps (every nonzero entry selected, no counts), with windows that
start anywhere in the cloud and hang past its end (a few entries set past
it, which both versions ignore), at every (C, W) that the served
configurations pool, and stress rows: none selected, every column
selected, ties, -0 beside +0, -inf, a count beyond the row's entries
and one below them, at C from 1 to 512. On the CPU the plain version is
held to a float64 numpy max, and a numpy model of the kernel (the walk's
list of selected columns, the lane groups, the batches, the merge by
shuffles) to the plain version, in every vector width; ``max_index`` is
held to the JAX op's (its Pallas kernels in interpret mode, JAX imported
inside the test). Tests marked ``cuda`` hold the kernel bitwise to the
plain version (values, ``arg``, ``max_index``, the values-only launch),
and skip where there is no card (run them there with ``python -m pytest
tests/test_torch_pool_fwd.py -m cuda --noconftest``).
"""

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import dense as D

TILE = 128
LANES = 32
BATCH = 8          # the kernel's hits in flight a group (kBatch)
STEP = 512         # the kernel's window columns a walk step (kStep)
# (C, W) of every pool of the served configurations (the pooled level's
# last conv width and its pool window), and the ModelNet level-0 conv map
# that the max_index replay pools (bins, C = 32 features + 3 xyz)
SERVED = {
    "modelnet_l0": (64, 1920), "modelnet_l1": (128, 1280),
    "modelnet_l2": (128, 1152), "modelnet_hard_l0": (64, 2688),
    "modelnet_hard_l1": (128, 1408),
    "s3dis_l0": (128, 2048), "s3dis_l1": (256, 1152),
    "s3dis_l2": (256, 768), "s3dis_l3": (512, 640),
    "bins_c35": (35, 1536),
}
STRESS_C = (1, 3, 35, 131, 512)
DTYPES = (torch.float32, torch.bfloat16)


def _ranked(rng, sel, k):
    """Rank map bytes from a (rows, W) selection: ranks 1.. in window
    order, entries past rank k set to 0 (the query's cap)."""
    ranks = np.cumsum(sel, axis=-1) * sel
    return np.where(ranks <= k, ranks, 0).astype(np.int8)


def _operands(seed, c, window, kind, batch=1, n_t=2, num_in=None, k=64):
    """(packed (B, n_t, 128, W) int8, s_blk (B, n_t) int64, counts (B, M)
    int32 or None, x (B, N, C) f32 integers with -0, M) as numpy arrays.
    Windows start anywhere in the cloud (the first tile's at its start);
    the last tile's hangs past its end, with a few selected entries there
    (ignored by both versions).
    ``kind``: "ranks", "bins" or "stress" (a rank map whose rows are the
    cases of the module docstring, one a row in turn, and features with
    normal rows and rows of -inf)."""
    rng = np.random.default_rng(seed)
    num_in = num_in or window + 300
    m_pad = n_t * TILE
    m = m_pad - 37                      # padded query rows past M
    n_blk = -(-num_in // TILE)
    s_blk = rng.integers(0, n_blk, (batch, n_t))
    s_blk[:, 0] = 0                     # inside the cloud
    s_blk[:, -1] = n_blk - 1            # hangs past the cloud's end
    rows = batch * m_pad
    dens = rng.uniform(0.01, 0.08, (rows, 1))
    sel = rng.random((rows, window)) < dens
    counts = None
    if kind == "bins":
        packed = np.where(sel, rng.integers(1, 34, (rows, window)), 0)
        packed = packed.astype(np.int8)
    else:
        packed = _ranked(rng, sel, k)
        cnt = (packed > 0).sum(-1)
        if kind == "stress":
            case = np.arange(rows) % 6
            packed[case == 0] = 0                              # none
            # every column nonzero, ranks 1..127 over and over: with a
            # count of 127 (or no counts) every column is selected
            packed[case == 1] = np.arange(window) % 127 + 1
            cnt = (packed > 0).sum(-1)
            cnt[case == 1] = 127
            cnt[case == 2] += rng.integers(1, 20, (case == 2).sum())
            cnt[case == 3] = np.maximum(cnt[case == 3] - 3, 0)
            cnt[case == 4] = 127
        counts = cnt.reshape(batch, m_pad)[:, :m].astype(np.int32)
    packed = packed.reshape(batch, n_t, TILE, window)
    x = rng.integers(-3, 4, (batch, num_in, c)).astype(np.float32)
    x[(x == 0) & (rng.random(x.shape) < 0.5)] = -0.0
    if kind == "stress":
        x[:, ::7] = rng.standard_normal((batch, len(x[0, ::7]), c))
        x[:, 5::11] = -np.inf
    return packed, s_blk, counts, x, m


def _torch(ops, dtype, device="cpu"):
    packed, s_blk, counts, x, _ = ops
    t = [torch.from_numpy(a).to(device) for a in (packed, s_blk)]
    cnt = None if counts is None else torch.from_numpy(counts).to(device)
    return (*t, cnt, torch.from_numpy(x).to(dtype).to(device))


def _numpy_pool(packed, s_blk, counts, x):
    """(out f64, arg, index) of the formula, row by row: the max over the
    selected in-cloud columns, -0 folded to +0, the first column
    attaining it (-1 if none), its cloud row clamped to N - 1."""
    batch, n_t, _, w = packed.shape
    num_in, c = x.shape[1:]
    m_pad = n_t * TILE
    cnt = np.full((batch, m_pad), 127)
    if counts is not None:
        cnt[:] = 0
        cnt[:, :counts.shape[1]] = counts
    out = np.zeros((batch, m_pad, c))
    arg = np.full((batch, m_pad, c), -1)
    index = np.zeros((batch, m_pad, c), np.int64)
    for b in range(batch):
        for t in range(m_pad):
            base = int(s_blk[b, t // TILE]) * TILE
            pk = packed[b, t // TILE, t % TILE].astype(np.int64)
            cols = np.nonzero((pk >= 1) & (pk <= min(cnt[b, t], 127))
                              & (base + np.arange(w) < num_in))[0]
            index[b, t] = min(base, num_in - 1)
            if len(cols) == 0:
                continue
            vals = x[b, base + cols].astype(np.float64) + 0.0
            out[b, t] = vals.max(0)
            arg[b, t] = cols[np.argmax(vals == out[b, t], axis=0)]
            index[b, t] = np.minimum(base + arg[b, t], num_in - 1)
    return out, arg, index


def _check_plain(ops, dtype):
    args = _torch(ops, dtype)
    out, arg, index = D.rank_pool_plain(*args, with_arg=True,
                                        with_index=True)
    want_out, want_arg, want_index = _numpy_pool(
        ops[0], ops[1], ops[2], args[3].float().numpy())
    assert out.dtype == dtype and arg.dtype == index.dtype == torch.int32
    assert torch.equal(out, torch.from_numpy(want_out).to(dtype))
    np.testing.assert_array_equal(arg.numpy(), want_arg)
    np.testing.assert_array_equal(index.numpy(), want_index)
    # the bits of -0 folded to +0
    assert not torch.signbit(out[out == 0]).any()
    assert torch.equal(D.rank_pool_plain(*args), out)
    only_arg = D.rank_pool_plain(*args, with_arg=True)
    only_index = D.rank_pool_plain(*args, with_index=True)
    assert torch.equal(only_arg[1], arg) and torch.equal(only_index[1],
                                                         index)
    return out, arg, index


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(SERVED))
def test_plain_matches_numpy_on_served_shapes(case, dtype):
    c, window = SERVED[case]
    kind = "bins" if case.startswith("bins") else "ranks"
    out, arg, _ = _check_plain(_operands(len(case), c, window, kind),
                               dtype)
    assert (arg >= 0).any() and (arg == -1).any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", STRESS_C)
def test_plain_matches_numpy_on_stress_rows(c, dtype):
    ops = _operands(c + 1, c, 640, "stress")
    out, arg, _ = _check_plain(ops, dtype)
    # the cases are there: an empty row, a row taking every column (of
    # a window inside the cloud: the first tile's)
    packed, s_blk, counts, _, m = ops
    assert (arg[0, 0] == -1).all() and (out[0, 0] == 0).all()
    assert (packed.reshape(-1, 640)[1] > 0).all() and counts[0, 1] == 127
    assert s_blk[0, 0] * TILE + 640 <= ops[3].shape[1]
    every = torch.from_numpy(ops[3][0, :640]).to(dtype).float().amax(0)
    assert torch.equal(out[0, 1].float(), every + 0.0)


def test_served_shapes_are_the_configs():
    from sph3d_gcn_torch.configs import modelnet_config, s3dis_config

    want = set()
    for cfg in (modelnet_config(fast=True, dense=True),
                modelnet_config(fast=True, dense=True, family="hard"),
                s3dis_config(fast=True, dense=True)):
        for lv in range(len(cfg.radius)):
            want.add((cfg.channels[lv][-1], cfg.pool_window(lv)))
    got = {v for k, v in SERVED.items() if not k.startswith("bins")}
    assert want <= got
    cfg = modelnet_config(fast=True, dense=True)
    assert SERVED["bins_c35"][1] == cfg.enc_window(0)


def _kernel_model(packed, s_blk, counts, x, vec_bytes, elem):
    """The kernel's steps in numpy, lane by lane: (out f32, arg, index).

    Per query row (one warp): the walk takes STEP columns a step, lane l
    the 16 bytes 16l..16l+15; a lane's place in the list is the selected
    bytes of the lanes before it (a warp scan) after the list so far.
    The fold splits the lanes into groups of ``width`` (one vector of
    E = vec_bytes / elem channels a lane, 32 vectors a pass); group
    g takes hits g, g + groups, ... in batches of BATCH, a strictly
    larger value replacing the best, from -inf at the group's first
    hit's column (IEEE compares: -0 and +0 tie); the groups merge by xor
    shuffles at distances width, 2 width, ..., 16 under "larger value,
    then smaller column"; an output -0 is folded to +0."""
    batch, n_t, _, w = packed.shape
    num_in, c = x.shape[1:]
    e_per = vec_bytes // elem
    nvec = c // e_per
    width = 32 if nvec >= 32 else 1 << (nvec - 1).bit_length()
    groups = LANES // width
    lanes = np.arange(LANES)
    grp, gl = lanes // width, lanes % width
    m_pad = n_t * TILE
    out = np.zeros((batch, m_pad, c), np.float32)
    arg = np.zeros((batch, m_pad, c), np.int64)
    index = np.zeros((batch, m_pad, c), np.int64)
    for b in range(batch):
        for t in range(m_pad):
            g = t // TILE
            base = int(s_blk[b, g]) * TILE
            if counts is None:
                cnt = 127
            else:
                cnt = int(counts[b, t]) if t < counts.shape[1] else 0
            cnt = min(max(cnt, 0), 127)
            live = max(0, min(w, num_in - base))
            row = packed[b, g, t % TILE].astype(np.int64)
            lst = []
            for c0 in range(0, live, STEP):
                cols = c0 + 16 * lanes[:, None] + np.arange(16)  # (32, 16)
                byte = np.where(cols < live, row[np.minimum(cols, w - 1)],
                                0)
                bits = (byte >= 1) & (byte <= cnt) & (cols < live)
                per_lane = bits.sum(1)
                if per_lane.sum() == 0:
                    continue
                at = len(lst) + np.concatenate([[0], np.cumsum(per_lane)])
                step = [0] * per_lane.sum()
                for lane in range(LANES):
                    own = cols[lane][bits[lane]]
                    for i, col in enumerate(own):
                        step[at[lane] + i - len(lst)] = int(col)
                lst += step
            n_hit = len(lst)
            for p in range(-(-nvec // 32)):
                v = p * 32 + gl                                 # (32,)
                active = v < nvec
                ch = np.minimum(v, nvec - 1)[:, None] * e_per + np.arange(
                    e_per)                                      # (32, E)
                best = np.full((LANES, e_per), -np.inf, np.float32)
                # a group starts from its first hit's column (0xffff: none)
                best_w = np.where(grp < n_hit, np.array(
                    lst + [0xffff] * LANES)[grp], 0xffff)[:, None] + 0 * ch
                for gr in range(groups):
                    ln = lanes[grp == gr]       # the group's lanes
                    for i0 in range(gr, n_hit, groups * BATCH):
                        for j in range(BATCH):  # folded in list order
                            i = i0 + j * groups
                            if i >= n_hit:
                                break
                            col = lst[i]
                            vals = x[b, base + col][ch[ln]]
                            better = vals > best[ln]        # strict
                            best[ln] = np.where(better, vals, best[ln])
                            best_w[ln] = np.where(better, col, best_w[ln])
                off = width
                while off < LANES:
                    ob, ow = best[lanes ^ off], best_w[lanes ^ off]
                    better = (ob > best) | ((ob == best) & (ow < best_w))
                    best = np.where(better, ob, best)
                    best_w = np.where(better, ow, best_w)
                    off *= 2
                for lane in range(width):
                    if not active[lane]:
                        continue
                    if n_hit:
                        out[b, t, ch[lane]] = best[lane] + np.float32(0)
                        arg[b, t, ch[lane]] = best_w[lane]
                        index[b, t, ch[lane]] = np.minimum(
                            base + best_w[lane], num_in - 1)
                    else:
                        arg[b, t, ch[lane]] = -1
                        index[b, t, ch[lane]] = min(base, num_in - 1)
    return out, arg, index


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", (1, 3, 35, 64, 131, 512))
def test_kernel_model_matches_plain(c, dtype, offset):
    """The numpy model of the kernel equals the plain version, in the
    vector width the wrapper picks for the features (``offset``: a view
    one row of channels into a larger tensor, which narrows it for odd
    C)."""
    ops = _operands(c + 7, c, 384, "stress", num_in=700)
    packed, s_blk, counts, x = _torch(ops, dtype)
    flat = torch.cat([x.reshape(-1)[:offset], x.reshape(-1)])
    xs = flat[offset:].view(x.shape)    # an address `offset` elements on
    elem = x.element_size()
    vec = D._pool_vector_bytes(c * elem, xs)
    assert vec >= elem and (c * elem) % vec == 0
    if c == 64:
        assert vec == (16 if not offset else elem)
    ref = D.rank_pool_plain(packed, s_blk, counts, xs, with_arg=True,
                            with_index=True)
    got = _kernel_model(ops[0], ops[1], ops[2], xs.float().numpy(), vec,
                        elem)
    assert torch.equal(torch.from_numpy(got[0]).to(dtype), ref[0])
    np.testing.assert_array_equal(got[1], ref[1].numpy())
    np.testing.assert_array_equal(got[2], ref[2].numpy())


@pytest.mark.parametrize("maps", ["ranks", "bins"])
@pytest.mark.parametrize("c", [35, 131])
def test_max_index_matches_jax(maps, c):
    """``max_index`` of the plain version (the kernel's ``with_index``
    output, through ``dense_max_pool3d``) equals the JAX op's, run as the
    JAX tests run it on the CPU (Pallas in interpret mode), in bf16 on
    graphs of both kinds at widths outside the served pools (the C = 35
    bin map of the max_index replay, and 131)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from sph3d_gcn_tpu.ops import dense as jd
    from test_torch_dense_conv_pool import both_graphs, sorted_clouds

    pts = sorted_clouds(c)
    if maps == "ranks":
        q = np.ascontiguousarray(pts[:, ::4])
        jg, tg = both_graphs(pts, q, 0.2, 16, None, 512, False)
    else:
        jg, tg = both_graphs(pts, pts, 0.2, 32, (8, 2, 2), 384, True)
    rng = np.random.default_rng(c)
    feats = rng.integers(-3, 4, (2, pts.shape[1], c)).astype(np.float32)
    ref, ref_idx = jd.dense_max_pool3d(jnp.asarray(feats, jnp.bfloat16), jg,
                                       with_index=True)
    x = torch.from_numpy(feats).to(torch.bfloat16)
    out, idx = D.dense_max_pool3d(x, tg, with_index=True)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    counts = D.pool_counts(tg)
    if maps == "ranks":
        assert counts is tg.count
    else:
        assert counts is None
    _, index = D.rank_pool_plain(tg.packed, tg.s_blk, counts, x,
                                 with_index=True)
    assert torch.equal(index[:, :tg.num_query], idx)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _kernel_vs_plain(args):
    """Every output of the kernel equal to the plain version's, in every
    mode, and a second launch to the same bits."""
    full = D.rank_pool_kernel(*args, with_arg=True, with_index=True)
    ref = D.rank_pool_plain(*args, with_arg=True, with_index=True)
    for got, want in zip(full, ref):
        assert torch.equal(got.cpu(), want.cpu())
    assert torch.equal(D.rank_pool_kernel(*args), ref[0])
    got = D.rank_pool_kernel(*args, with_arg=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = D.rank_pool_kernel(*args, with_index=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[2])
    again = D.rank_pool_kernel(*args, with_arg=True, with_index=True)
    assert all(torch.equal(a, b) for a, b in zip(full, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(SERVED))
def test_kernel_matches_plain_on_served_shapes_on_cuda(cuda_device, case,
                                                       dtype):
    c, window = SERVED[case]
    kind = "bins" if case.startswith("bins") else "ranks"
    ops = _operands(len(case), c, window, kind, batch=3, n_t=3)
    _kernel_vs_plain(_torch(ops, dtype, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_stress_rows_on_cuda(cuda_device, dtype):
    """Every stress row at C from 1 to 512, with the features in place
    and as views whose address narrows the vectors, and the counts as a
    (B, M) view of wider rows, as the query's counts are."""
    for c in STRESS_C + (64, 128, 256):
        ops = _operands(c + 1, c, 640, "stress", batch=2)
        packed, s_blk, counts, x = _torch(ops, dtype, cuda_device)
        _kernel_vs_plain((packed, s_blk, counts, x))
        flat = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])
        _kernel_vs_plain((packed, s_blk, counts, flat[1:].view(x.shape)))
        wide = torch.zeros((counts.shape[0], s_blk.shape[1] * TILE),
                           dtype=torch.int32, device=cuda_device)
        wide[:, :counts.shape[1]] = counts
        view = wide[:, :counts.shape[1]]
        assert not view.is_contiguous()
        _kernel_vs_plain((packed, s_blk, view, x))
        _kernel_vs_plain((packed, s_blk, None, x))
