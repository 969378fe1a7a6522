"""The dense conv backward (``csrc/dense_conv_bwd.cu``, K5), its plain
version and its launch layout, on operands made with numpy from a seed.

The maps have windows that start in tile order (as a sorted cloud's do)
and may hang past the cloud's end, clouds whose size is no multiple of
128, windows of 128 to 2304 columns, empty rows and empty tiles, a few
selected entries past the cloud's end (both versions ignore them), and a
crowded case with 64 selected entries per query row, as real scene
blocks have. On the CPU the plain version is held to a float64 numpy sum
of the function's two formulas; tests marked ``cuda`` hold the kernel to
the plain version (the gate of ``chip_smoke.py``), to a second kernel run
bitwise and to the numpy sum, and skip where there is no card (run them
there with ``python -m pytest tests/test_torch_conv_bwd.py -m cuda
--noconftest``). No JAX is imported here.
"""

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import dense as D

TILE = 128
CHANNELS = (1, 35, 64, 67, 131, 256, 257, 512, 1024)
# (clouds, input rows, query tiles, window, selected entries per row,
# empty tiles)
CASES = {
    "sparse": (2, 700, 5, 384, 6, False),
    "wide": (1, 650, 3, 2304, 12, False),
    "crowded": (1, 700, 2, 640, 64, False),
    "empty": (2, 520, 4, 128, 6, True),
}
# the plain version's one-hot costs W*C a row: wide rows take narrower
# windows (2304 columns up to C = 56, past the cloud's end up to C = 256)
MAX_WC = 1 << 17
# f32 sums of up to ~2000 products in another order than the f64 sum
F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -8     # dx rounded once to bfloat16
# the kernel against the plain version: chip_smoke.py's conv_grads_close
DX_RTOL, DX_ATOL, DFILT_TOL = 1e-2, 1e-3, 1e-4


def _window(case, c):
    return max(TILE, min(CASES[case][3], MAX_WC // c // TILE * TILE))


def _operands(seed, case, c, mult, f_bins, dtype):
    """(packed, s_blk, x, filt_b, inv, dout) as numpy arrays, x and dout
    already rounded to ``dtype``."""
    batch, num_in, n_t, _, per_row, empty = CASES[case]
    window = _window(case, c)
    rng = np.random.default_rng(seed)
    n_blk = -(-num_in // TILE)
    s_blk = np.sort(rng.integers(0, n_blk, (batch, n_t)), axis=1)
    reach = np.minimum(window, num_in - s_blk * TILE)[..., None, None]
    # per row, the columns of its smallest scores among those in the cloud
    scores = np.where(np.arange(window) >= reach, 2.0,
                      rng.random((batch, n_t, TILE, window)))
    rank = np.argsort(np.argsort(scores, axis=-1), axis=-1)
    if per_row == 64:
        count = np.full((batch, n_t, TILE, 1), per_row)
    else:
        count = rng.integers(0, 2 * per_row + 1, (batch, n_t, TILE, 1))
        count[rng.random(count.shape) < 0.1] = 0
    sel = (rank < count) & (scores < 2.0)
    # now and then one entry past the cloud's end
    past = (scores == 2.0) & (rng.random(scores.shape) < 0.002)
    packed = np.where(sel | past,
                      rng.integers(1, f_bins + 1, scores.shape), 0)
    if empty:
        packed[:, 1::2] = 0
    packed = packed.astype(np.int8)
    inv = 1.0 / np.maximum(sel.sum(-1), 1).reshape(batch, n_t * TILE)
    x = torch.randn(batch, num_in, c, generator=torch.Generator()
                    .manual_seed(seed)).to(dtype).float().numpy()
    dout = torch.randn(batch, n_t * TILE, c * mult,
                       generator=torch.Generator().manual_seed(seed + 1)
                       ).to(dtype).float().numpy()
    filt_b = rng.standard_normal((batch, f_bins, c, mult)).astype(np.float32)
    return packed, s_blk, x, filt_b, inv.astype(np.float32), dout


def _brute_force(packed, s_blk, x, filt_b, inv, dout):
    """(dx, dfilt_b) in float64 from the formulas: every selected entry
    (t, w) inside the cloud adds g[t] . filt_b[bin] to dx[row] and
    g[t] * x[row] to dfilt_b[bin]. The entries are summed per target with
    ``np.add.reduceat``, sorted by target, 4096 at a time."""
    batch, num_in, c = x.shape
    f_bins, mult = filt_b.shape[1], filt_b.shape[3]
    b, tile, t, w = np.nonzero(packed)
    rows = s_blk[b, tile] * TILE + w
    keep = rows < num_in
    b, tile, t, w, rows = b[keep], tile[keep], t[keep], w[keep], rows[keep]
    f = packed[b, tile, t, w].astype(np.int64) - 1
    q = tile * TILE + t

    def g(h):
        return (inv[b[h], q[h], None].astype(np.float64)
                * dout[b[h], q[h]]).reshape(-1, c, mult)

    dx = np.zeros((batch * num_in, c))
    dfilt = np.zeros((batch * f_bins, c, mult))
    for out, target, term in (
            (dx, b * num_in + rows,
             lambda h: (g(h) * filt_b[b[h], f[h]]).sum(-1)),
            (dfilt, b * f_bins + f,
             lambda h: g(h) * x[b[h], rows[h], :, None])):
        order = np.argsort(target, kind="stable")
        for s in range(0, order.size, 4096):
            h = order[s:s + 4096]
            uniq, start = np.unique(target[h], return_index=True)
            out[uniq] += np.add.reduceat(term(h), start, axis=0)
    return (dx.reshape(batch, num_in, c),
            dfilt.reshape(batch, f_bins, c, mult))


def _torch_args(ops, dtype, device):
    packed, s_blk, x, filt_b, inv, dout = (torch.from_numpy(a).to(device)
                                           for a in ops)
    return packed, s_blk, x.to(dtype), filt_b, inv, dout.to(dtype)


def _assert_near_reference(dx, dfilt, ref, dtype):
    """dx and dfilt against the float64 sums: f32 sum-order error, and for
    bfloat16 dx its one rounding."""
    dx_ref, dfilt_ref = (torch.from_numpy(a) for a in ref)
    scale = max(dx_ref.abs().max().item(), 1e-30)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(dx.double().cpu(), dx_ref, rtol=rtol,
                               atol=F32_TOL * scale)
    scale = max(dfilt_ref.abs().max().item(), 1e-30)
    torch.testing.assert_close(dfilt.double().cpu(), dfilt_ref, rtol=F32_TOL,
                               atol=F32_TOL * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_brute_force(case, c, mult, dtype):
    f_bins = (17, 33)[CHANNELS.index(c) % 2]
    ops = _operands(c + mult, case, c, mult, f_bins, dtype)
    dx, dfilt = D.dense_conv_bwd_plain(*_torch_args(ops, dtype, "cpu"))
    assert dx.dtype == dtype and dfilt.dtype == torch.float32
    assert dx.shape == ops[2].shape and dfilt.shape == ops[3].shape
    _assert_near_reference(dx, dfilt, _brute_force(*ops), dtype)


def test_operands_cover_the_cases():
    """The cases hold what they are named for: 64 entries in every row
    of the crowded maps, empty tiles, entries past the cloud's end,
    windows past the cloud."""
    packed, s_blk = _operands(0, "crowded", 64, 2, 33, torch.float32)[:2]
    rows = s_blk[..., None, None] * TILE + np.arange(packed.shape[-1])
    inside = (packed != 0) & (rows < CASES["crowded"][1])
    reach = np.minimum(CASES["crowded"][1] - rows[..., :1], 64)
    assert (inside.sum(-1) == reach[..., 0]).all() and (reach == 64).any()
    empty = _operands(0, "empty", 64, 2, 33, torch.float32)[0]
    assert not empty[:, 1::2].any() and empty[:, ::2].any()
    packed, s_blk = _operands(0, "wide", 35, 2, 33, torch.float32)[:2]
    rows = s_blk[..., None, None] * TILE + np.arange(packed.shape[-1])
    assert ((packed != 0) & (rows >= CASES["wide"][1])).any()
    assert packed.shape[-1] == 2304 and CASES["wide"][1] % TILE


@pytest.mark.parametrize("f_bins", [33, 127])
@pytest.mark.parametrize("owners,tiles", [(1024, 1024), (48, 48), (16, 16)])
def test_layout_covers_every_channel_once(owners, tiles, f_bins):
    """``conv_bwd_layout`` against a numpy enumeration of the lanes: every
    channel c < C lies in exactly one (chunk, slot, lane) of the dx owners,
    no chunk is empty, at most 4 slots, and the filter slice within its
    shared memory; the dx owners give each of the card's 132 SMs one
    unless the narrowest layout gives fewer; a dfilt block takes 1, 2 or 4
    slots, its partial within its shared memory, reads the map once per
    128 channels where that fits, and its tile is split into the fewest
    parts that give 528 blocks (four an SM)."""
    for mult in (1, 2):
        for c in range(1, 1025):
            dx_slots, dx_chunks, df_slots, df_split = D.conv_bwd_layout(
                c, mult, f_bins, owners, tiles)
            lanes = np.arange(dx_chunks * 32 * dx_slots).reshape(
                dx_chunks, dx_slots, 32)
            live = lanes < c
            assert 1 <= dx_slots <= 4
            assert live.sum() == c
            assert live.reshape(dx_chunks, -1).any(1).all()
            assert f_bins * 32 * dx_slots * mult * 4 <= 36 * 1024 or (
                dx_slots == 1)
            assert dx_chunks * owners >= 132 or dx_chunks == -(-c // 32)
            assert df_slots in (1, 2, 4)
            slab = f_bins * 32 * df_slots * mult * 4
            assert slab <= 36 * 1024 or df_slots == 1
            df_chunks = -(-c // (32 * df_slots))
            if f_bins == 33:
                assert df_chunks == -(-c // 128)
                assert 32 * df_slots < 2 * c or df_slots == 1
            assert df_split in (1, 2, 4, 8)
            blocks = df_chunks * tiles * np.array([1, 2, 4, 8])
            assert df_split == 8 or blocks[int(np.log2(df_split))] >= 528
            assert df_split == 1 or blocks[int(np.log2(df_split)) - 1] < 528


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, case):
    """K5 at every width and depth multiplier against the plain version
    (chip_smoke.py's gate), a second run bitwise, and the float64 sums; in
    its own layout and in each dx slot count with each dfilt slot count
    and row split (these small clouds alone would take one dx slot and
    eight parts)."""
    for c in CHANNELS:
        for mult in (1, 2):
            f_bins = (17, 33)[CHANNELS.index(c) % 2]
            ops = _operands(c + mult, case, c, mult, f_bins, dtype)
            args = _torch_args(ops, dtype, cuda_device)
            dx_p, dfilt_p = D.dense_conv_bwd_plain(*args)
            ref = _brute_force(*ops)
            layouts = [None] + [
                (s, -(-c // (32 * s)), df_slots, split)
                for s, df_slots, split in ((1, 1, 1), (2, 2, 2), (3, 4, 4),
                                           (4, 4, 8))]
            for layout in layouts:
                dx, dfilt = D.dense_conv_bwd_kernel(*args, layout=layout)
                torch.testing.assert_close(
                    dx.float(), dx_p.float(), rtol=DX_RTOL,
                    atol=DX_ATOL * dx_p.abs().max().item())
                torch.testing.assert_close(
                    dfilt, dfilt_p, rtol=DFILT_TOL,
                    atol=DFILT_TOL * dfilt_p.abs().max().item())
                dx2, dfilt2 = D.dense_conv_bwd_kernel(*args, layout=layout)
                assert torch.equal(dx, dx2), (c, layout)
                assert torch.equal(dfilt, dfilt2), (c, layout)
                _assert_near_reference(dx, dfilt, ref, dtype)
