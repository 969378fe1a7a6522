"""The max-pool backward (``csrc/rank_pool_bwd.cu``, K6) and its plain
version on operands that stress one owner per 128-row block.

The operands are made with numpy from a seed: tiles whose windows start
anywhere in the cloud (not only in order), windows up to 2304 rows (18
blocks), clouds whose size is no multiple of 128, rows and single
entries with ``arg == -1``, and a crowded case in which every query row
of several tiles with the same window routes to one input row, so that
one target gets the most contributions. ``dout`` is integer-valued, so
every sum is exact in any order. On the CPU the plain version is held to
a brute-force numpy sum; tests marked ``cuda`` hold the kernel bitwise to
the plain version and to a second kernel run, and skip where there is no
card (run them there with ``python -m pytest tests/test_torch_pool_bwd.py
-m cuda --noconftest``). No JAX is imported here.
"""

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import dense as D

TILE = 128
CHANNELS = (1, 31, 33, 64, 128, 131, 256, 257, 448, 512)
# (clouds, input rows, query tiles, window, crowded)
CASES = {
    "spread": (2, 1000, 5, 384, False),
    "wide": (2, 2900, 7, 2304, False),
    "crowded": (2, 2900, 6, 2304, True),
}


def _operands(seed, batch, num_in, n_t, window, c, crowded):
    """(s_blk (B, n_t), arg (B, n_t*128, C) int32, dout f32 integers):
    every live column lands on a row of the cloud, as K4's do."""
    rng = np.random.default_rng(seed)
    n_blk = -(-num_in // TILE)
    s_blk = rng.integers(0, n_blk, (batch, n_t)).astype(np.int32)
    rows_left = num_in - s_blk * TILE          # rows from the window start
    reach = np.minimum(window, rows_left)[..., None, None]
    arg = (rng.random((batch, n_t, TILE, c)) * reach).astype(np.int32)
    if crowded:
        # every row of tiles 1..n_t-1 shares tile 1's window and routes to
        # the last cloud row in that window
        s_blk[:, 1:] = s_blk[:, 1:2]
        arg[:, 1:] = reach[:, 1:2] - 1
    empty = rng.random((batch, n_t, TILE, 1)) < 0.1       # empty rows
    arg[empty | (rng.random(arg.shape) < 0.05)] = -1
    dout = rng.integers(-4, 5, arg.shape).astype(np.float32)
    shape = (batch, n_t * TILE, c)
    return s_blk, arg.reshape(shape), dout.reshape(shape)


def _brute_force(s_blk, arg, dout, num_in):
    """(dx summed in f64, the number of terms of each dx entry)."""
    batch, _, c = arg.shape
    dx = np.zeros((batch, num_in, c))
    terms = np.zeros((batch, num_in, c), dtype=np.int64)
    b, t, ch = np.nonzero(arg >= 0)
    rows = s_blk[b, t // TILE] * TILE + arg[b, t, ch]
    np.add.at(dx, (b, rows, ch), dout[b, t, ch])
    np.add.at(terms, (b, rows, ch), 1)
    return dx, terms


def _torch_args(ops, dtype, device, num_in, window):
    s_blk, arg, dout = (torch.from_numpy(a).to(device) for a in ops)
    return s_blk, arg, dout.to(dtype), num_in, window


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", CHANNELS)
def test_plain_matches_brute_force(c, dtype, case):
    batch, num_in, n_t, window, crowded = CASES[case]
    ops = _operands(c, batch, num_in, n_t, window, c, crowded)
    got = D.rank_pool_bwd_plain(*_torch_args(ops, dtype, "cpu", num_in,
                                             window))
    dx, terms = _brute_force(*ops, num_in)
    assert got.dtype == dtype
    assert torch.equal(got, torch.from_numpy(dx).float().to(dtype))
    # crowded: one row per cloud and channel takes nearly every row of 5
    # tiles
    assert terms.max() > (4 * TILE if crowded else 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, case):
    """K6 bitwise against the plain version and against itself, at every
    width (one 32-channel slice to 16, ragged last slices)."""
    batch, num_in, n_t, window, crowded = CASES[case]
    for c in CHANNELS:
        ops = _operands(c, batch, num_in, n_t, window, c, crowded)
        args = _torch_args(ops, dtype, cuda_device, num_in, window)
        dx = D.rank_pool_bwd_kernel(*args)
        assert torch.equal(dx, D.rank_pool_bwd_plain(*args)), c
        assert torch.equal(dx, D.rank_pool_bwd_kernel(*args)), c
        want = torch.from_numpy(_brute_force(*ops, num_in)[0]).float()
        assert torch.equal(dx.cpu(), want.to(dtype)), c
