"""Edge gather of the per-edge engine (counterpart of
``sph3d_gcn_tpu/ops/windowed.py``).

Every per-edge op of the engine gathers its neighbors' features
``(B, N, C) x (B, M, K) -> (B, M_pad, K, C)``, with M_pad = M rounded up
to the 128-row tile and exact zeros on invalid lanes (``k >= count`` and
the padded rows). The JAX package computes that gather as one-hot
matrix products over row windows of an axis-sorted cloud, with a window
certificate and a fallback to the plain gather, because the TPU's
per-index gather and scatter are slow. On the GPU it is a gather and its
transpose a segment sum:

- forward, ``csrc/window_gather.cu`` (K8, TPU kernel #14): reads each
  edge's row by its index, so it is exact for every index and the window
  plays no part;
- backward, ``csrc/window_gather_bwd.cu`` (K9, TPU kernel #15 and the
  scatter after it): a lane group per feature row (:func:`gather_bwd_layout`,
  :func:`funnel_layout`) sums that row's edge gradients in (m, k) order
  from inverse edge lists (:func:`edge_lists`, a stable sort of the edges
  by target row), in f32 with one rounding. No float atomics: bitwise reproducible. The lists
  are built once per neighborhood (:class:`EdgeLists`): a level's two
  convs share them. The same kernel sums the dense window sums' gradients
  into the cloud (:func:`window_sum_bwd_kernel`, the backward of the
  dense unpools and the avg pool in ``ops/dense.py``), forming each
  window column's gradient from the map and ``dout`` as it goes.

Both have a plain PyTorch twin here, taken for a CPU tensor; a CUDA
tensor goes to the kernel or the call raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sph3d_gcn_torch import _build
from sph3d_gcn_torch.ops.gather import gather_features

TILE = 128     # M is padded to whole 128-row tiles, as in the JAX op

GATHER_KERNEL = _build.register(
    "window_gather", "sph3d_window_gather_launch",
    [_build.PTR] * 4 + [_build.INT] * 8 + [_build.PTR],
)
# K8's block: about this many output bytes, and at most this many bytes of
# staged indices (4 an edge)
GATHER_BLOCK_BYTES = 32 * 1024
GATHER_STAGE_BYTES = 48 * 1024
GATHER_BWD_KERNEL = _build.register(
    "window_gather_bwd", "sph3d_window_gather_bwd_launch",
    [_build.PTR] * 4 + [_build.INT] * 7 + [_build.PTR],
)
# K9's form (b), a second entry counted with form (a)'s launches
SUM_BWD_KERNEL = _build.register(
    "window_gather_bwd", "sph3d_window_sum_bwd_launch",
    [_build.PTR, _build.INT] + [_build.PTR] * 3 + [_build.INT] * 9
    + [_build.PTR],
)
# K9's lane groups: a lane holds at most this many bytes of a row a pass,
# in at most this many vectors (csrc/window_gather_bwd.cu::max_slots)
GATHER_BWD_LANE_BYTES = 16
GATHER_BWD_MAX_SLOTS = 3
# K9's form (a) on rows off whole aligned 16-byte vectors: the most
# 16-byte output chunks a lane takes a pass (kFunnelSlots)
FUNNEL_SLOTS = 2
# K9's form (b): a block owns this many consecutive cloud rows, and the
# windows are whole chunks of them
SUM_UNIT = 16
# K9's form (b): its lhs kinds, the int8 map / f32 / bf16 weights
_SUM_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_rows(t: torch.Tensor, m_pad: int, value: int = 0) -> torch.Tensor:
    """Pad axis 1 of a (B, M, ...) tensor to ``m_pad`` rows."""
    pad = [0, 0] * (t.dim() - 2) + [0, m_pad - t.shape[1]]
    return F.pad(t, pad, value=value)


def lane_mask(count: torch.Tensor, k: int) -> torch.Tensor:
    """(B, M_pad) counts -> (B, M_pad, K) bool: lane k < count."""
    return torch.arange(k, device=count.device) < count[..., None]


def window_gather_plain(feats: torch.Tensor, idx: torch.Tensor,
                        count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K8: (B, N, C), (B, M, K) int64, (B, M) int64
    -> (B, M_pad, K, C) in ``feats``' dtype, invalid lanes 0."""
    m_pad = _round_up(idx.shape[1], TILE)
    idx_p = _pad_rows(idx, m_pad)
    valid = lane_mask(_pad_rows(count, m_pad), idx.shape[2])
    g = gather_features(feats, idx_p.clamp(0, feats.shape[1] - 1))
    return torch.where(valid[..., None], g, 0)


def gather_rows(k: int, row_bytes: int) -> int:
    """The query rows one block of K8 writes: a power of two from 8 (so
    that a block's output, 8*K rows of ``row_bytes``, is whole 16-byte
    chunks) to 128 (so that a block stays in one cloud), doubled while the
    block writes at most :data:`GATHER_BLOCK_BYTES` and stages at most
    :data:`GATHER_STAGE_BYTES` of indices. (Fewer rows, down to the fewest
    whose output is whole chunks, made the odd-C calls of the per-edge
    forward 8-12% slower on the H100; PERF.md.)"""
    rows = 8
    while (rows < TILE and 2 * rows * k * row_bytes <= GATHER_BLOCK_BYTES
           and 2 * rows * k * 4 <= GATHER_STAGE_BYTES):
        rows *= 2
    return rows


def window_gather_kernel(feats: torch.Tensor, idx: torch.Tensor,
                         count: torch.Tensor) -> torch.Tensor:
    """The gather through ``csrc/window_gather.cu`` (K8): a block per
    :func:`gather_rows` query rows stages their edges' source rows, then
    writes its output in 16-byte streaming stores whatever C is. Returns
    as :func:`window_gather_plain`."""
    _build.check(feats, "feats", (torch.float32, torch.bfloat16), 3)
    _build.check(idx, "idx", torch.int64, 3)
    _build.check(count, "count", torch.int64, 2)
    batch, n, c = feats.shape
    _, m, k = idx.shape
    if idx.shape[0] != batch or count.shape != (batch, m) or n < 1:
        raise ValueError(
            f"bad gather shapes: feats {tuple(feats.shape)}, idx "
            f"{tuple(idx.shape)}, count {tuple(count.shape)}")
    m_pad = _round_up(m, TILE)
    out = torch.empty((batch, m_pad, k, c), dtype=feats.dtype,
                      device=feats.device)
    elem = feats.element_size()
    GATHER_KERNEL.launch(
        _build.ptr(feats), _build.ptr(idx), _build.ptr(count),
        _build.ptr(out), batch, n, m, m_pad, k, c, elem,
        gather_rows(k, c * elem), _build.stream(feats),
    )
    return out


def edge_lists(idx: torch.Tensor, count: torch.Tensor,
               num_in: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse edge lists of a neighborhood, the backward's operands.

    Returns (order (B * M_pad * K,) int32: the ids of the padded
    (B, M_pad, K) edges grouped by target row ``b * num_in + idx``, each
    group in (m, k) order, the invalid edges last; starts (B * num_in + 1,)
    int32: row r's edges are ``order[starts[r]:starts[r + 1]]``). A stable
    sort and a binary search: deterministic on every device."""
    batch, m, k = idx.shape
    m_pad = _round_up(m, TILE)
    rows = batch * num_in
    valid = lane_mask(count, k)
    base = torch.arange(batch, device=idx.device)[:, None, None] * num_in
    key = torch.where(valid, idx + base, rows).to(torch.int32)
    return group_by_row(_pad_rows(key, m_pad, value=rows).reshape(-1), rows)


def group_by_row(key: torch.Tensor,
                 rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, starts) of :func:`edge_lists` from each edge's flat target
    row ``key`` (int32, ``rows`` for an invalid edge)."""
    sorted_key, order = torch.sort(key, stable=True)
    # row r's group starts at the first key >= r
    starts = torch.searchsorted(
        sorted_key, torch.arange(rows + 1, dtype=torch.int32,
                                 device=key.device))
    return order.to(torch.int32), starts.to(torch.int32)


class EdgeLists:
    """The inverse edge lists of one neighborhood, built by the first
    backward through it and reused by every later one: gathers through
    the same (idx, count), such as a level's two convs, share them."""

    def __init__(self, idx: torch.Tensor, count: torch.Tensor) -> None:
        self.idx = idx.long().contiguous()
        self.count = count.long().contiguous()
        self._lists: tuple[torch.Tensor, torch.Tensor] | None = None

    def get(self, num_in: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(order, starts) of :func:`edge_lists` over ``num_in`` rows (the
        gathered features' N, the same for every gather through it)."""
        if self._lists is None:
            self._lists = edge_lists(self.idx, self.count, num_in)
        return self._lists


def _sum_in_order(src: torch.Tensor, pos: torch.Tensor | None,
                  starts: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, C) f32: row r the sum, in f32 and in list order, of
    ``src[pos[i]]`` (``src[i]`` for ``pos`` None) over its entries
    ``i = starts[r] .. starts[r + 1] - 1``. The i-th entries of all rows
    are added in one step, so no two adds meet a row at once: K9's order
    on every device."""
    first, length = starts[:-1].long(), starts.diff()
    out = torch.zeros((rows, src.shape[-1]), dtype=torch.float32,
                      device=src.device)
    for i in range(int(length.max()) if rows else 0):
        live = torch.nonzero(length > i).squeeze(1)
        at = first[live] + i
        out[live] += src[at if pos is None else pos[at].long()].float()
    return out


def window_gather_bwd_plain(dg: torch.Tensor, order: torch.Tensor,
                            starts: torch.Tensor,
                            num_in: int) -> torch.Tensor:
    """Plain PyTorch twin of K9's form (a): (B, M_pad, K, C) edge
    gradients -> (B, num_in, C) in ``dg``'s dtype, summed in f32 in list
    order and rounded once."""
    batch, c = dg.shape[0], dg.shape[-1]
    dx = _sum_in_order(dg.reshape(-1, c), order, starts, batch * num_in)
    return dx.reshape(batch, num_in, c).to(dg.dtype)


def window_lists(s_blk: torch.Tensor, window: int,
                 num_in: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse lists of the dense window rows: (order, starts) of
    :func:`group_by_row` over the (B * nT * W) window rows ``g * W + w``,
    keyed by their cloud row ``b * num_in + s_blk[g] * 128 + w`` (rows past
    the cloud last): each cloud row's window rows in ascending tile."""
    batch, n_t = s_blk.shape
    dev = s_blk.device
    rows = s_blk.reshape(-1, 1).long() * TILE + torch.arange(window,
                                                             device=dev)
    cloud = torch.arange(batch, device=dev).repeat_interleave(n_t)[:, None]
    key = torch.where(rows < num_in, cloud * num_in + rows, batch * num_in)
    return group_by_row(key.to(torch.int32).reshape(-1), batch * num_in)


def window_sum_bwd_plain(lhs: torch.Tensor, s_blk: torch.Tensor,
                         dout: torch.Tensor, num_in: int) -> torch.Tensor:
    """Plain PyTorch twin of K9's form (b), the dense window sums'
    backward: (B, num_in, C) f32 from ``dout`` (B, nT * 128, C) f32.

    Window row w of tile g (cloud row ``s_blk[g] * 128 + w``) has the term
    ``sum over r ascending of lhs[g, r, w] * dout[g * 128 + r]`` over its
    selected entries (``lhs`` the int8 map, selected > 0, factor 1; or f32
    / bf16 weights, selected nonzero; the product and the add each rounded
    in f32), and each cloud row sums the terms of its window rows in the
    order of :func:`window_lists`, as :func:`window_gather_bwd_plain` sums
    edge gradients. A loop over the columns' selected entries, then over
    the lists."""
    batch, n_t, tile, w = lhs.shape
    c = dout.shape[-1]
    cols = lhs.transpose(2, 3).reshape(-1, tile)       # (G * W, 128)
    sel = cols > 0 if lhs.dtype == torch.int8 else cols != 0
    col, r = torch.nonzero(sel, as_tuple=True)         # r ascending a column
    vals = dout.reshape(-1, c)[(col // w) * tile + r]
    if lhs.dtype != torch.int8:
        vals = cols[col, r].float()[:, None] * vals
    col_starts = F.pad(sel.sum(1).cumsum(0), (1, 0))
    terms = _sum_in_order(vals, None, col_starts, batch * n_t * w)
    order, starts = window_lists(s_blk, w, num_in)
    dx = _sum_in_order(terms, order, starts, batch * num_in)
    return dx.reshape(batch, num_in, c)


def address_align(*tensors: torch.Tensor) -> int:
    """The largest of 16, 8, 4, 2, 1 that divides every tensor's address."""
    return next(a for a in (16, 8, 4, 2, 1)
                if all(t.data_ptr() % a == 0 for t in tensors))


def gather_bwd_layout(c: int, elem: int,
                      align: int = 16) -> tuple[int, int, int, int]:
    """K9's lane groups for rows of ``c`` elements of ``elem`` bytes at
    addresses aligned to ``align`` bytes: (group, vec, slots, passes).

    The row is read as ``vec``-byte vectors, the widest of 16, 8, 4, 2 (at
    least an element) that divides the row's bytes and ``align`` and that
    leaves no lane idle (below). Its owner is a group of ``group`` lanes:
    the most, at most 32, that its vectors fill, a power of two (as K4
    sizes its groups; for a row of 2^k 16-byte vectors, the smallest group
    that covers it); a warp owns 32 / group rows. Lane l takes vectors l +
    group * q; pass p the slots q = p, p + passes, ..., ``slots`` a pass,
    at most :data:`GATHER_BWD_LANE_BYTES` bytes and
    :data:`GATHER_BWD_MAX_SLOTS` vectors a lane, so that every lane has a
    vector in every pass (an element's width always allows that)."""
    row = c * elem
    for vec in (16, 8, 4, 2):
        if vec < elem or row % vec or align % vec:
            continue
        nv = row // vec
        group = min(32, 1 << (nv.bit_length() - 1))
        per_lane = -(-nv // group)
        most = min(GATHER_BWD_MAX_SLOTS, GATHER_BWD_LANE_BYTES // vec)
        passes = -(-per_lane // most)
        if group * passes <= nv:        # lane group - 1 in the last pass
            return group, vec, -(-per_lane // passes), passes
    raise AssertionError(f"no K9 layout for C={c}, {elem}-byte elements")


def funnel_layout(c: int, elem: int) -> tuple[int, int, int]:
    """K9's form (a) layout for rows of ``c`` elements of ``elem`` bytes
    that are not whole 16-byte vectors at 16-byte aligned addresses:
    (group, slots, passes).

    The row's output chunks are its ``ceil(c * elem / 16)`` 16-byte
    pieces. A group of ``group`` lanes (a power of two, 2 to 32; a warp
    owns 32 / group rows) takes them in units of ``group - 1``: lane l of
    unit u loads aligned chunk ``u * (group - 1) + l`` of the edge's row
    and owns the output chunk of that index if l < group - 1, joining its
    chunk to lane l + 1's (``csrc/window_gather_bwd.cu``). ``group`` is the
    largest with ``group - 1`` at most the chunks, so the first unit fills
    the group; pass p takes units p, p + passes, ..., ``slots`` a pass, at
    most :data:`FUNNEL_SLOTS`."""
    chunks = -(-c * elem // 16)
    group = max(2, min(32, 1 << (chunks + 1).bit_length() - 1))
    units = -(-chunks // (group - 1))
    passes = -(-units // FUNNEL_SLOTS)
    return group, -(-units // passes), passes


def _layout_of(src: torch.Tensor, dx: torch.Tensor) -> list[int]:
    """K9's form (b) launch layout for rows of ``dx`` read from ``src``:
    [nv, group, slots, passes, vec] (:func:`gather_bwd_layout`)."""
    c, elem = dx.shape[-1], dx.element_size()
    group, vec, slots, passes = gather_bwd_layout(
        c, elem, address_align(src, dx))
    return [c * elem // vec, group, slots, passes, vec]


def window_gather_bwd_kernel(dg: torch.Tensor, order: torch.Tensor,
                             starts: torch.Tensor,
                             num_in: int) -> torch.Tensor:
    """The segment sum through ``csrc/window_gather_bwd.cu`` (K9, form
    (a)): a lane group per feature row, reading 16-byte vectors
    (:func:`gather_bwd_layout`) where the rows are whole aligned vectors,
    else aligned 16-byte chunks joined by a funnel shift
    (:func:`funnel_layout`). Returns as :func:`window_gather_bwd_plain`."""
    _build.check(dg, "dg", (torch.float32, torch.bfloat16), 4)
    _build.check(order, "order", torch.int32, 1)
    _build.check(starts, "starts", torch.int32, 1)
    batch, m_pad, k, c = dg.shape
    if order.numel() != batch * m_pad * k or starts.numel() != (
            batch * num_in + 1):
        raise ValueError(
            f"bad edge lists: order {tuple(order.shape)}, starts "
            f"{tuple(starts.shape)} for dg {tuple(dg.shape)}, N={num_in}")
    dx = torch.empty((batch, num_in, c), dtype=dg.dtype, device=dg.device)
    elem = dg.element_size()
    group, vec, slots, passes = gather_bwd_layout(c, elem,
                                                  address_align(dg, dx))
    funnel = vec < 16
    if funnel:
        group, slots, passes = funnel_layout(c, elem)
    GATHER_BWD_KERNEL.launch(
        _build.ptr(dg), _build.ptr(order), _build.ptr(starts),
        _build.ptr(dx), batch * num_in, c, group, slots, passes,
        int(funnel), int(dg.dtype == torch.bfloat16), _build.stream(dg),
    )
    return dx


def window_sum_bwd_kernel(lhs: torch.Tensor, s_blk: torch.Tensor,
                          dout: torch.Tensor, num_in: int) -> torch.Tensor:
    """The dense window sums' backward through ``csrc/window_gather_bwd.cu``
    (K9, form (b)): a block of :data:`SUM_UNIT` consecutive cloud rows
    walks the tiles whose windows hold them (from ``s_blk``, in ascending
    tile: :func:`window_lists`' order), forms each window row's gradient from
    ``lhs`` (the int8 map, or f32 / bf16 weights, (B, nT, 128, W), W a
    multiple of 16) and ``dout`` and sums them. Returns as
    :func:`window_sum_bwd_plain`."""
    _build.check(lhs, "lhs", tuple(_SUM_KIND), 4)
    _build.check(dout, "dout", torch.float32, 3)
    batch, n_t, tile, w = lhs.shape
    c = dout.shape[2]
    if (tile != TILE or dout.shape[:2] != (batch, n_t * TILE)
            or s_blk.shape != (batch, n_t)):
        raise ValueError(f"bad window sum: lhs {tuple(lhs.shape)}, s_blk "
                         f"{tuple(s_blk.shape)}, dout {tuple(dout.shape)}")
    if w % SUM_UNIT or lhs.data_ptr() % 16:
        raise ValueError(f"K9 takes windows of whole {SUM_UNIT}-row chunks "
                         f"on a 16-byte aligned map, got W={w} at "
                         f"{lhs.data_ptr() % 16} bytes past 16")
    s_blk = s_blk.to(torch.int64).contiguous()   # a graph's, as it is
    _build.check(s_blk, "s_blk", torch.int64, 2)
    dx = torch.empty((batch, num_in, c), dtype=torch.float32,
                     device=dout.device)
    SUM_BWD_KERNEL.launch(
        _build.ptr(lhs), _SUM_KIND[lhs.dtype], _build.ptr(s_blk),
        _build.ptr(dout), _build.ptr(dx), batch, num_in, n_t, w,
        *_layout_of(dout, dx), _build.stream(dout),
    )
    return dx


class _WindowGather(torch.autograd.Function):
    """K8 with K9 as its backward, through the neighborhood's
    :class:`EdgeLists`. The graph is a constant: no gradient for it."""

    @staticmethod
    def forward(ctx, feats, lists, use_kernels):
        idx, count = lists.idx, lists.count
        _build.record("window_gather", feats, idx, count)
        ctx.lists = lists
        ctx.num_in = feats.shape[1]
        ctx.use_kernels = use_kernels
        if _build.use_kernel(feats, use_kernels):
            return window_gather_kernel(feats, idx, count)
        return window_gather_plain(feats, idx, count)

    @staticmethod
    def backward(ctx, dg):
        args = (dg.contiguous(), *ctx.lists.get(ctx.num_in), ctx.num_in)
        _build.record("window_gather_bwd", *args)
        if _build.use_kernel(dg, ctx.use_kernels):
            dx = window_gather_bwd_kernel(*args)
        else:
            dx = window_gather_bwd_plain(*args)
        return dx, None, None


def windowed_gather_padded(
    feats: torch.Tensor,
    idx: torch.Tensor,
    count: torch.Tensor,
    *,
    window: int,
    lists: EdgeLists | None = None,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The engine's edge gather, tile-padded.

    Args:
      feats:  (B, N, C) float features (f32 or bf16).
      idx:    (B, M, K) neighbor indices into N.
      count:  (B, M) valid-lane counts.
      window: the JAX op's row-window width, kept for API parity. The
        result does not depend on it: the kernel reads rows by index.
      lists:  the :class:`EdgeLists` of this (idx, count), to share the
        backward's lists with other gathers through it; None: its own.

    Returns:
      (g, valid): g (B, M_pad, K, C) in ``feats``' dtype, M_pad = M rounded
      up to 128, invalid lanes (``k >= count`` and padded rows) exactly 0;
      valid the (B, M_pad, K) bool lane mask. Differentiable in ``feats``.
    """
    del window
    if lists is None:
        lists = EdgeLists(idx, count)
    elif lists.idx.shape != idx.shape or lists.count.shape != count.shape:
        raise ValueError(
            f"edge lists of a {tuple(lists.idx.shape)} neighborhood for "
            f"idx {tuple(idx.shape)}")
    m_pad = _round_up(idx.shape[1], TILE)
    g = _WindowGather.apply(feats.contiguous(), lists, use_kernels)
    return g, lane_mask(_pad_rows(lists.count, m_pad), idx.shape[2])


def windowed_gather(
    feats: torch.Tensor,
    idx: torch.Tensor,
    count: torch.Tensor,
    *,
    window: int,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """``(B, N, C) x (B, M, K) -> (B, M, K, C)`` with invalid lanes 0: the
    unpadded form of :func:`windowed_gather_padded`."""
    g, _ = windowed_gather_padded(feats, idx, count, window=window,
                                  use_kernels=use_kernels)
    return g[:, : idx.shape[1]]
