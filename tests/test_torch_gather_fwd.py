"""The per-edge engine's edge gather (``csrc/window_gather.cu``, K8) and
its plain version, on operands made with numpy from a seed.

``g[b, m, k] = feats[b, idx[b, m, k]]`` for ``k < count[b, m]`` and
``m < M``, exact zeros elsewhere up to ``M_pad`` (M rounded up to 128).
The operands have C from 1 to 131 channels (rows of 2 to 524 bytes, most
of them no multiple of 16), f32 and bf16, M no multiple of 128, rows with
count 0 and count K, K = 1 and odd K, indices out of range (clamped),
and features at addresses 2 to 12 bytes past a 16-byte boundary (views
into larger tensors). On the CPU the plain version is held to numpy, and
a numpy model of the kernel's byte-level work (the blocks of
:func:`windowed.gather_rows` query rows, each thread's 16-byte chunks
and their positions advanced without a division, the pieces a chunk
takes from one edge or several, each read by aligned 4-byte words that
hold its bytes and a funnel shift, or one 16-byte load) to the plain
version byte for byte, in memory with guard bytes around the features
that no output byte may show. Tests marked ``cuda`` hold the kernel
bitwise to the plain version and skip where there is no card (run them
there with ``python -m pytest tests/test_torch_gather_fwd.py -m cuda
--noconftest``). No JAX is imported here.
"""

import numpy as np
import pytest
import torch

from sph3d_gcn_torch.ops import windowed as W

TILE = 128
THREADS = 256      # the kernel's block (kThreads)
CHANNELS = (1, 3, 35, 64, 67, 128, 131)
DTYPES = (torch.float32, torch.bfloat16)
GUARD = 32         # guard bytes around the model's features


def _operands(seed, batch, n, m, k, c):
    """(feats f32 (B, N, C), idx int64 (B, M, K), count int64 (B, M)) as
    numpy arrays: indices near a sorted base (a few out of range), every
    count from 0 to K."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.integers(0, n, (batch, m)), axis=-1)
    idx = base[..., None] + rng.integers(-40, 40, (batch, m, k))
    idx[:, ::17] = rng.integers(-5, n + 5, idx[:, ::17].shape)
    count = rng.integers(0, k + 1, (batch, m))
    count[:, 0], count[:, 1] = 0, k
    feats = rng.standard_normal((batch, n, c)).astype(np.float32)
    return feats, idx.astype(np.int64), count.astype(np.int64)


def _numpy_gather(feats, idx, count):
    batch, m, k = idx.shape
    m_pad = -(-m // TILE) * TILE
    out = np.zeros((batch, m_pad, k, feats.shape[-1]), feats.dtype)
    src = np.clip(idx, 0, feats.shape[1] - 1)
    live = np.arange(k) < count[..., None]
    for b in range(batch):
        out[b, :m] = np.where(live[b, ..., None], feats[b][src[b]], 0)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_plain_matches_numpy(c, dtype):
    feats, idx, count = _operands(c, 2, 300, 130, 5, c)
    x = torch.from_numpy(feats).to(dtype)
    got = W.window_gather_plain(x, torch.from_numpy(idx),
                                torch.from_numpy(count))
    want = _numpy_gather(x.float().numpy(), idx, count)
    assert got.shape == (2, 256, 5, c) and got.dtype == dtype
    assert torch.equal(got.float(), torch.from_numpy(want))
    assert not torch.signbit(got[:, 130:]).any()    # +0 past M


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_on_views_and_narrow_neighborhoods(dtype):
    """A view one element into a larger tensor, a channel slice (not
    contiguous: the engine's entry makes it so), K = 1."""
    feats, idx, count = _operands(3, 2, 300, 200, 1, 35)
    x = torch.from_numpy(feats).to(dtype)
    i, n = torch.from_numpy(idx), torch.from_numpy(count)
    ref = W.window_gather_plain(x, i, n)
    flat = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(x.shape)
    assert torch.equal(W.window_gather_plain(flat, i, n), ref)
    wide = torch.cat([x, x[..., :3]], dim=-1)[..., :35]
    assert not wide.is_contiguous()
    g, valid = W.windowed_gather_padded(wide, i, n, window=512)
    assert torch.equal(g, ref) and valid.shape == (2, 256, 1)
    want = _numpy_gather(x.float().numpy(), idx, count)
    assert torch.equal(ref.float(), torch.from_numpy(want))


@pytest.mark.parametrize("c", (1, 3, 35, 64, 131, 512))
@pytest.mark.parametrize("k", (1, 5, 64))
@pytest.mark.parametrize("elem", (2, 4))
def test_gather_rows(elem, k, c):
    """A block's query rows: a power of two from 8 to 128 (so a block is
    whole 16-byte chunks and stays in one cloud), its output near 32 KB
    and its staged indices within 48 KB."""
    row_bytes = c * elem
    rows = W.gather_rows(k, row_bytes)
    assert rows in (8, 16, 32, 64, 128)
    assert (rows * k * row_bytes) % 16 == 0
    assert rows * k * 4 <= W.GATHER_STAGE_BYTES
    assert rows == 8 or rows * k * row_bytes <= W.GATHER_BLOCK_BYTES
    if rows < 128:     # doubling would pass a limit
        assert (2 * rows * k * row_bytes > W.GATHER_BLOCK_BYTES
                or 2 * rows * k * 4 > W.GATHER_STAGE_BYTES)


def _merge_piece(words, mem, mem_addr, src, pos, length, loads):
    """The kernel's merge_piece on the model's memory: chunk bytes [pos,
    pos + length) from source address ``src``, by the aligned 4-byte
    words that hold them. Each loaded word is checked to hold a byte of
    the piece's source and recorded in ``loads``."""
    v = src - pos
    a, sh = v & ~3, v & 3
    x = []
    for j in range(5):
        lo = 4 * j - sh
        if lo + 4 > pos and lo < pos + length:
            addr = a + 4 * j
            assert addr < src + length and addr + 4 > src
            loads.append(addr)
            x.append(int.from_bytes(mem[addr - mem_addr:addr - mem_addr + 4]
                                    .tobytes(), "little"))
        else:
            x.append(0)
    for i in range(4):
        val = ((x[i + 1] << 32 | x[i]) >> (8 * sh)) & 0xffffffff
        b0, b1 = max(pos - 4 * i, 0), min(pos + length - 4 * i, 4)
        if b0 < b1:
            mask = ((1 << (8 * b1)) - 1) & ~((1 << (8 * b0)) - 1)
            words[i] = (words[i] & ~mask & 0xffffffff) | (val & mask)


def _kernel_model(x, idx, count, offset):
    """The kernel's output bytes, computed as its threads do, with the
    features at ``offset`` bytes past a 16-byte boundary in memory with
    guard bytes (0xAB) on both sides. Returns (out bytes, the loads'
    addresses, whether any chunk took its 16-byte fast path)."""
    batch, n, c = x.shape
    _, m, k = idx.shape
    elem = x.element_size()
    row_bytes = c * elem
    m_pad = -(-m // TILE) * TILE
    raw = x.contiguous().view(torch.uint8).numpy().reshape(-1)
    mem_addr = 4096
    feat_addr = mem_addr + GUARD + offset
    mem = np.full(GUARD + offset + raw.size + GUARD, 0xAB, np.uint8)
    mem[GUARD + offset:GUARD + offset + raw.size] = raw
    rows = W.gather_rows(k, row_bytes)
    per = 16 // elem
    step_edges, step_ch = divmod(THREADS * per, c)
    out = np.zeros(batch * m_pad * k * row_bytes, np.uint8)
    loads, fast = [], False
    for blk in range(batch * m_pad // rows):
        r0 = blk * rows
        b, m0 = divmod(r0, m_pad)
        src = np.full(rows * k, -1)
        for i in range(rows * k):
            r, kk = divmod(i, k)
            if m0 + r < m and kk < count[b, m0 + r]:
                src[i] = b * n + min(max(int(idx[b, m0 + r, kk]), 0), n - 1)
        chunks = rows * k * row_bytes // 16
        dst = r0 * k * row_bytes
        for tid in range(THREADS):
            edge, ch = divmod(tid * per, c)
            for q in range(tid, chunks, THREADS):
                assert (edge, ch) == divmod(q * per, c)
                words = [0, 0, 0, 0]
                e, off, pos = edge, ch, 0
                while pos < 16:
                    length = min(16 - pos, (c - off) * elem)
                    if src[e] >= 0:
                        p = feat_addr + (int(src[e]) * c + off) * elem
                        if length == 16 and p % 16 == 0:
                            fast = True
                            loads.append(p)
                            chunk = mem[p - mem_addr:p - mem_addr + 16]
                            words = [int.from_bytes(chunk[4 * i:4 * i + 4]
                                                    .tobytes(), "little")
                                     for i in range(4)]
                        else:
                            _merge_piece(words, mem, mem_addr, p, pos,
                                         length, loads)
                    pos += length
                    e, off = e + 1, 0
                at = dst + 16 * q
                out[at:at + 16] = np.frombuffer(
                    b"".join(w.to_bytes(4, "little") for w in words),
                    np.uint8)
                edge, ch = edge + step_edges, ch + step_ch
                if ch >= c:
                    edge, ch = edge + 1, ch - c
    return out, np.array(loads), fast


@pytest.mark.parametrize("offset", (0, 1, 3))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", (1, 3, 35, 64, 67, 131))
def test_kernel_model_matches_plain(c, dtype, offset):
    """The model's bytes equal the plain version's (two clouds, M no
    multiple of 128, odd K), no output byte comes from a guard, and every
    load lies inside the features' words; rows of whole 16-byte chunks
    take the 16-byte path."""
    feats, idx, count = _operands(c + offset, 2, 200, 70, 3, c)
    x = torch.from_numpy(feats).to(dtype)
    ref = W.window_gather_plain(x, torch.from_numpy(idx),
                                torch.from_numpy(count))
    elem = x.element_size()
    got, loads, fast = _kernel_model(x, idx, count, offset * elem)
    assert np.array_equal(got, ref.contiguous().view(torch.uint8).numpy()
                          .reshape(-1))
    lo = 4096 + GUARD + offset * elem
    hi = lo + x.numel() * elem
    assert loads.min() >= lo - 3 and loads.max() < hi
    if (c * elem) % 16 == 0 and offset == 0:
        assert fast


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_cuda(cuda_device, dtype):
    """Every width, the features in place and 1 or 3 elements past their
    tensor's start, K of 1, 5 and 64, M no multiple of 128."""
    for c in CHANNELS + (256, 512):
        for k, m in ((1, 200), (5, 130), (64, 300)):
            feats, idx, count = _operands(c + k, 2, 700, m, k, c)
            x = torch.from_numpy(feats).to(dtype).to(cuda_device)
            i = torch.from_numpy(idx).to(cuda_device)
            n = torch.from_numpy(count).to(cuda_device)
            ref = W.window_gather_plain(x, i, n)
            for offset in (0, 1, 3):
                flat = torch.cat([x.reshape(-1)[:offset], x.reshape(-1)])
                xs = flat[offset:].view(x.shape)
                got = W.window_gather_kernel(xs, i, n)
                assert torch.equal(got, ref), (c, k, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("c", (35, 67, 131))
def test_kernel_matches_plain_at_served_size_on_cuda(cuda_device, c):
    """The per-edge engine's odd widths at the level-0 size of a ModelNet
    batch (16 clouds of 10000 points, 2500 queries, K = 64), bf16."""
    feats, idx, count = _operands(c, 16, 10000, 2500, 64, c)
    x = torch.from_numpy(feats).to(torch.bfloat16).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    n = torch.from_numpy(count).to(cuda_device)
    assert torch.equal(W.window_gather_kernel(x, i, n),
                       W.window_gather_plain(x, i, n))
