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
  scatter after it): one warp per feature row sums that row's edge
  gradients in (m, k) order from inverse edge lists (:func:`edge_lists`,
  a stable sort of the edges by target row), in f32 with one rounding.
  No float atomics: bitwise reproducible. The lists are built once per
  neighborhood (:class:`EdgeLists`): a level's two convs share them.

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
    [_build.PTR] * 4 + [_build.INT] * 3 + [_build.PTR],
)


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


def window_gather_bwd_plain(dg: torch.Tensor, order: torch.Tensor,
                            starts: torch.Tensor,
                            num_in: int) -> torch.Tensor:
    """Plain PyTorch twin of K9: (B, M_pad, K, C) edge gradients ->
    (B, num_in, C) in ``dg``'s dtype, summed in f32 in list order (the
    kernel's order, on every device: the i-th edges of all rows are added
    in one step, so no two adds meet a row at once) and rounded once."""
    batch, c = dg.shape[0], dg.shape[-1]
    rows = batch * num_in
    src = dg.reshape(-1, c)
    first, length = starts[:-1].long(), starts.diff()
    dx = torch.zeros((rows, c), dtype=torch.float32, device=dg.device)
    for i in range(int(length.max()) if rows else 0):
        live = torch.nonzero(length > i).squeeze(1)
        dx[live] += src[order[first[live] + i].long()].float()
    return dx.reshape(batch, num_in, c).to(dg.dtype)


def window_gather_bwd_kernel(dg: torch.Tensor, order: torch.Tensor,
                             starts: torch.Tensor,
                             num_in: int) -> torch.Tensor:
    """The segment sum through ``csrc/window_gather_bwd.cu`` (K9): one
    warp per feature row. Returns as :func:`window_gather_bwd_plain`."""
    _build.check(dg, "dg", (torch.float32, torch.bfloat16), 4)
    _build.check(order, "order", torch.int32, 1)
    _build.check(starts, "starts", torch.int32, 1)
    batch, m_pad, k, c = dg.shape
    rows = batch * num_in
    if order.numel() != batch * m_pad * k or starts.numel() != rows + 1:
        raise ValueError(
            f"bad edge lists: order {tuple(order.shape)}, starts "
            f"{tuple(starts.shape)} for dg {tuple(dg.shape)}, N={num_in}")
    dx = torch.empty((batch, num_in, c), dtype=dg.dtype, device=dg.device)
    GATHER_BWD_KERNEL.launch(
        _build.ptr(dg), _build.ptr(order), _build.ptr(starts),
        _build.ptr(dx), rows, c, int(dg.dtype == torch.bfloat16),
        _build.stream(dg),
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
