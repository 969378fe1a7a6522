"""The dense conv forward (``csrc/dense_conv.cu``, K3), its plain version
and its launch layout, on operands made with numpy from a seed.

The maps have windows that start in tile order (as a sorted cloud's do)
and may hang past the cloud's end, clouds whose size is no multiple of
128, windows of 128 to 2304 columns, empty rows and empty tiles, a few
selected entries past the cloud's end (both versions ignore them), a
crowded case with 64 selected entries per query row, as real scene
blocks have, and an ungrouped case whose filter is one (F, C, r) filter
expanded over the clouds (read in place). On the CPU the plain version is
held to a float64 numpy sum of the formula and :func:`conv_fwd_layout`
to its invariants on every served shape; tests marked ``cuda`` hold the
kernel to the plain version (the gate of ``chip_smoke.py``), to a second
kernel run bitwise and to the numpy sum, in its own layout and in every
built slot count and row split, and skip where there is no card (run
them there with ``python -m pytest tests/test_torch_conv_fwd.py -m cuda
--noconftest``). No JAX is imported here.
"""

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import dense as D

TILE = 128
CHANNELS = (1, 35, 67, 131, 512, 1024)
# (clouds, input rows, query tiles, window, selected entries per row,
# empty tiles, one filter for every cloud)
CASES = {
    "sparse": (2, 700, 5, 384, 6, False, False),
    "wide": (1, 650, 3, 2304, 12, False, False),
    "crowded": (1, 700, 2, 640, 64, False, False),
    "empty": (2, 520, 4, 128, 6, True, False),
    "ungrouped": (3, 600, 3, 384, 8, False, True),
}
# the plain version's one-hot costs W*F a row and its window features W*C:
# wide rows take narrower windows on the CPU
MAX_WC = 1 << 17
F32_TOL = 1e-5            # f32 sums of up to 64 products in another order
BF16_RTOL = 2.0 ** -8     # the output rounded once to bfloat16
# the kernel against the plain version: chip_smoke.py's CONV_TOL for
# bf16, f32 sum-order error for f32
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (C, r, B * n_t) of every K3 call of the ModelNet and S3DIS paths (B=16:
# query clouds of 10000, 2500, 625 and 8192, 2048, 768, 384, 128 points)
SERVED = [(35, 2, 1264), (64, 1, 1264), (67, 1, 320), (64, 2, 320),
          (131, 1, 80), (128, 1, 80),
          (64, 2, 1024), (128, 2, 1024), (128, 2, 256), (256, 2, 256),
          (256, 2, 96), (256, 2, 48), (512, 2, 48), (512, 2, 16),
          (1024, 2, 48), (512, 2, 96), (512, 2, 256), (128, 2, 256)]


def _operands(seed, case, c, mult, f_bins, dtype, cap_window=True):
    """(packed, s_blk, x, filt_b, inv) as numpy arrays, x already rounded
    to ``dtype``; ``filt_b`` (1, F, C, r) for the ungrouped case."""
    batch, num_in, n_t, window, per_row, empty, shared = CASES[case]
    if cap_window:
        window = max(TILE, min(window, MAX_WC // c // TILE * TILE))
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
    filt_b = rng.standard_normal((1 if shared else batch, f_bins, c, mult)
                                 ).astype(np.float32)
    return packed, s_blk, x, filt_b, inv.astype(np.float32)


def _brute_force(packed, s_blk, x, filt_b, inv):
    """(B, n_t * 128, C * r) in float64 from the formula: every selected
    entry (t, w) inside the cloud adds x[row] * filt_b[bin] to row t,
    scaled by inv[t]."""
    batch, num_in, c = x.shape
    mult = filt_b.shape[3]
    n_t = packed.shape[1]
    b, tile, t, w = np.nonzero(packed)
    rows = s_blk[b, tile] * TILE + w
    keep = rows < num_in
    b, tile, t, w, rows = b[keep], tile[keep], t[keep], w[keep], rows[keep]
    f = packed[b, tile, t, w].astype(np.int64) - 1
    q = tile * TILE + t
    fb = filt_b[np.minimum(b, filt_b.shape[0] - 1), f]        # (H, C, r)
    out = np.zeros((batch * n_t * TILE, c, mult))
    np.add.at(out, b * n_t * TILE + q,
              x[b, rows, :, None].astype(np.float64) * fb)
    out *= inv.reshape(-1, 1, 1)
    return out.reshape(batch, n_t * TILE, c * mult)


def _torch_args(ops, dtype, device):
    packed, s_blk, x, filt_b, inv = (torch.from_numpy(a).to(device)
                                     for a in ops)
    # an ungrouped filter: one filter expanded over the clouds, as
    # ops.dense.conv_operands makes it
    filt_b = filt_b.expand(packed.shape[0], *filt_b.shape[1:])
    return packed, s_blk, x.to(dtype), filt_b, inv


def _assert_near_reference(out, ref, dtype):
    """The output against the float64 sum: f32 sum-order error, and for
    bfloat16 its one rounding."""
    ref = torch.from_numpy(ref)
    scale = max(ref.abs().max().item(), 1e-30)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out.double().cpu(), ref, rtol=rtol,
                               atol=F32_TOL * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("c", CHANNELS[:5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_brute_force(case, c, mult, dtype):
    f_bins = (17, 33)[CHANNELS.index(c) % 2]
    ops = _operands(c + mult, case, c, mult, f_bins, dtype)
    out = D.dense_conv_plain(*_torch_args(ops, dtype, "cpu"))
    assert out.dtype == dtype
    assert out.shape == (ops[0].shape[0], ops[0].shape[1] * TILE, c * mult)
    _assert_near_reference(out, _brute_force(*ops), dtype)


def test_operands_cover_the_cases():
    """The cases hold what they are named for: 64 entries in every row of
    the crowded maps, empty tiles, entries past the cloud's end, windows
    of 2304 columns past the cloud, one filter for the ungrouped case."""
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
    ops = _operands(0, "ungrouped", 35, 2, 33, torch.float32)
    args = _torch_args(ops, torch.float32, "cpu")
    assert ops[3].shape[0] == 1 and args[3].stride(0) == 0


def test_ungrouped_conv_operands_are_a_view():
    """``conv_operands`` on an ungrouped map hands the conv one filter
    expanded over the clouds (no copy), and its gradient still reaches
    the filter summed over the clouds."""
    ops = _operands(3, "ungrouped", 35, 2, 33, torch.float32)
    packed, s_blk, x, _, _ = _torch_args(ops, torch.float32, "cpu")
    count = (packed > 0).sum(-1, dtype=torch.int32).reshape(3, -1)
    dnbh = D.DenseNeighborhood(packed=packed, s_blk=s_blk, count=count,
                               ok=torch.tensor(True), num_query=384,
                               num_db=600)
    filt = torch.randn(33, 35, 2, requires_grad=True)
    filt_b, inv = D.conv_operands(x, filt, dnbh)
    assert filt_b.shape == (3, 33, 35, 2) and filt_b.stride(0) == 0
    torch.testing.assert_close(inv, 1.0 / count.clamp_min(1).float())
    out = D.dense_depthwise_conv3d(x, filt, dnbh)
    out.sum().backward()
    assert filt.grad is not None and filt.grad.abs().sum() > 0


@pytest.mark.parametrize("f_bins", [17, 33, 127])
@pytest.mark.parametrize("c,mult,tiles", SERVED)
def test_layout_of_served_shapes(c, mult, tiles, f_bins):
    """``conv_fwd_layout`` against a numpy enumeration of the lanes: every
    channel c < C lies in exactly one (slice, slot, lane), no slice is
    empty, the slot count is built and its filter slice within its
    shared memory (unless one slot is all there is), the row split is the
    fewest of 1, 2, 4, 8 that gives 528 items (four an SM), a slice only
    narrower than the filter allows where even 8 parts fall short, and
    the blocks persist where a filter slice of 24 KB or more meets fewer
    than 320 tiles."""
    slots, slices, split, persistent = D.conv_fwd_layout(c, mult, f_bins,
                                                         tiles)
    lanes = np.arange(slices * 32 * slots).reshape(slices, slots, 32)
    live = lanes < c
    assert slots in D.FWD_SLOTS
    assert live.sum() == c and live.reshape(slices, -1).any(1).all()
    widest = max([s for s in D.FWD_SLOTS
                  if f_bins * 32 * s * mult * 4 <= 36 * 1024] or [1])
    assert slots <= widest
    blocks = tiles * slices * np.array([1, 2, 4, 8])
    assert split in (1, 2, 4, 8)
    assert split == 8 or blocks[int(np.log2(split))] >= 528
    assert split == 1 or blocks[int(np.log2(split)) - 1] < 528
    if -(-c // (32 * widest)) < slices:
        assert tiles * -(-c // (32 * widest)) * 8 < 528
    assert persistent == (tiles < 320
                          and f_bins * 32 * slots * mult * 4 >= 24 * 1024)


def test_layout_of_the_main_paths():
    # the layouts the ModelNet and S3DIS calls take on the card: a block
    # an item on the ModelNet levels and the scenes' first, persistent
    # blocks on the scenes' deeper levels
    assert D.conv_fwd_layout(35, 2, 33, 1264) == (2, 1, 1, False)
    assert D.conv_fwd_layout(64, 1, 33, 1264) == (2, 1, 1, False)
    assert D.conv_fwd_layout(131, 1, 33, 80) == (5, 1, 8, False)
    assert D.conv_fwd_layout(128, 2, 33, 1024) == (4, 1, 1, False)
    assert D.conv_fwd_layout(128, 2, 33, 256) == (4, 1, 4, True)
    assert D.conv_fwd_layout(1024, 2, 33, 48) == (4, 8, 2, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _layouts(c):
    """The default layout, then each built slot count (as few slices as
    it allows) with each row split in turn, a block an item and
    persistent."""
    return [None] + [(s, -(-c // (32 * s)), (1, 2, 4, 8)[i % 4], persist)
                     for i, s in enumerate(D.FWD_SLOTS)
                     for persist in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, case):
    """K3 at every width and depth multiplier against the plain version,
    a second run bitwise, and the float64 sums; in its own layout and in
    each built slot count and row split. Windows of up to 2304 columns."""
    for c in CHANNELS:
        for mult in (1, 2):
            f_bins = (17, 33)[CHANNELS.index(c) % 2]
            ops = _operands(c + mult, case, c, mult, f_bins, dtype,
                            cap_window=False)
            args = _torch_args(ops, dtype, cuda_device)
            ref_p = D.dense_conv_plain(*args)
            ref = _brute_force(*ops)
            for layout in _layouts(c):
                out = D.dense_conv_kernel(*args, layout=layout)
                tol = KERNEL_TOL[dtype]
                torch.testing.assert_close(out.float(), ref_p.float(),
                                           rtol=tol, atol=tol)
                assert torch.equal(out, D.dense_conv_kernel(
                    *args, layout=layout)), (c, mult, layout)
                _assert_near_reference(out, ref, dtype)
