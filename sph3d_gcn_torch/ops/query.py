"""Dense windowed sphere query: packed int8 neighbor maps and, on request,
their f32 distance maps (counterpart of
``sph3d_gcn_tpu/ops/pallas/query_kernel.py``: ``_query_kernel`` and
``_growth_kernel``, the radius-growth query of the decoders' inter
graphs, see :func:`growth_query`).

For every 128-query tile and every column ``w`` of the tile's window of
axis-sorted database rows ``[s_blk*128, s_blk*128 + W)``:

  d3    = sqrt((dx*dx + dy*dy) + dz*dz),  delta = database - query
  in_r  = d3 < r  and  |d3 - r| > 1e-6          (ref tf_nnquery_gpu.cu:49)
  rank  = inclusive count of in_r along the window (point order)
  sel   = in_r and rank <= K                     (first K in point order)
  packed = sel ? (kernel ? bin + 1 : rank) : 0
  count  = #sel along the window = min(#in_r, K) (per query row)
  dist   = sel ? sqrt(d3) : 0                    (``need_dist`` only)

The distance map holds the square root of the Euclidean distance d3: the
reference's sqrt-space quirk (ref tf_nnquery_gpu.cu:54), which JAX's
per-edge ``Neighborhood.dist`` has too. It is what the weighted unpool
and IDS sampling read.

Columns at or past ``u_end`` chunks of 128 are zero (the slab-end bound
proves they hold no in-range candidate). Bins follow the compare-only
``_bins_822`` form for (8, 2, q) kernels, optionally SORT-GROUPED by the
cloud's sort axis (see :func:`bins_822`).

Every test above is a compare of ``d3``, and ``d3`` does not decrease as
``s = (dx*dx + dy*dy) + dz*dz`` grows (a correctly rounded square root),
so each flips at one f32 value of ``s``: :func:`query_thresholds` and
:func:`growth_thresholds` find those values, and the kernels compare
``s`` against them instead of taking a square root per candidate.

A CUDA tensor goes to ``csrc/dense_query.cu`` (``csrc/growth_query.cu``
for the growth query), a CPU tensor to :func:`dense_query_plain`
(:func:`growth_query_plain`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sph3d_gcn_torch import _build

TILE = 128
_BOUNDARY_EPS = 1e-6     # ref tf_nnquery_gpu.cu:49
_M_EPS = 1.01e-3         # ref tf_buildkernel_gpu.cu:6
_MAX_Q_BINS = 4          # radial thresholds the kernel takes as arguments
GROWTH_STEP = 0.05       # ref tf_nnquery_gpu.cu:30-60
_MAX_GROWTH = 15         # growth steps the kernel takes (16 radii)
# element budget of one (tiles, TILE, W) float temporary in the plain query
_PLAIN_BUDGET = 1 << 24

_F32_INF_BITS = 0x7F800000   # f32 bit patterns of s >= 0 run up to +inf

QUERY_KERNEL = _build.register(
    "dense_query", "sph3d_dense_query_launch",
    [_build.PTR] * 8 + [_build.INT] * 8 + [_build.FLOAT] * 5
    + [_build.PTR],
)
GROWTH_KERNEL = _build.register(
    "growth_query", "sph3d_growth_query_launch",
    [_build.PTR] * 9 + [_build.INT] * 7 + [_build.PTR],
)
# host array of the growth query's thresholds
_THRESHOLDS = ctypes.c_float * (_MAX_GROWTH + 1)
# the blocks a query call should give the card (four an SM of the H100's
# 132), and the most blocks a query tile may take (a block's 8 warps
# each walk one of its rows at least)
_QUERY_BLOCKS = 4 * 132
_MAX_SPLIT = 16


@functools.lru_cache(maxsize=None)
def query_split(tiles: int) -> int:
    """The blocks each of ``tiles`` = B * nT query tiles takes in K2 and
    K7 (1, 2, ..., 16; each block walks 128 / split of the tile's rows and
    stages the tile's window itself): the fewest that give the card
    ``_QUERY_BLOCKS`` blocks. A small call (the deep levels, the
    decoders) would otherwise leave most SMs idle and each warp walking 16
    rows one after another."""
    split = 1
    while tiles * split < _QUERY_BLOCKS and split < _MAX_SPLIT:
        split *= 2
    return split


def bin_thresholds(radius: float, q_bins: int) -> tuple[list[float], float]:
    """The f32 compare thresholds of the radial and self-loop tests, in the
    JAX kernel's exact rounding: radial ``f32(j*(r+1e-6)/q)**2`` (squared
    in f32) and self ``f32(float(f32(M_EPS + 1e-6))**2)``."""
    scale = float(radius) + 1e-6
    radial = [
        float(np.float32(j * scale / q_bins) ** 2)
        for j in range(1, q_bins)
    ]
    far = float(np.float32(float(np.float32(_M_EPS + 1e-6)) ** 2))
    return radial, far


def _first_sq(test) -> float:
    """The least f32 ``s >= 0`` whose f32 square root passes ``test``, a
    test that fails below some ``s`` and passes from it on (and passes at
    +inf): bisection over the f32 bit patterns, which order the
    non-negative floats as their values. numpy's f32 ``sqrt`` is correctly
    rounded, as CUDA's ``sqrtf`` and ``torch.sqrt`` on the card are."""
    lo, hi = 0, _F32_INF_BITS
    while lo < hi:
        mid = (lo + hi) // 2
        if test(np.sqrt(np.uint32(mid).view(np.float32))):
            hi = mid
        else:
            lo = mid + 1
    return float(np.uint32(lo).view(np.float32))


def _out_of_range(radius: np.float32):
    """The negated range test at ``radius`` on a distance ``d3``, in f32
    as the plain versions compute it (strict ``<`` with the 1e-6 margin)."""
    eps = np.float32(_BOUNDARY_EPS)
    return lambda d3: not (d3 < radius and abs(d3 - radius) > eps)


@functools.lru_cache(maxsize=None)
def query_thresholds(radius: float,
                     q_bins: int) -> tuple[float, tuple[float, ...], float]:
    """The squared-distance thresholds of one dense query: ``(t_in,
    t_radial, t_far)`` with, for every f32 ``s`` and ``d3 = sqrt(s)``,

      in range (``d3 < r and |d3 - r| > 1e-6``)  iff  s < t_in
      radial bin test j (``d3 >= thr_j``)       iff  s >= t_radial[j]
      not the self loop (``d3 > far``)          iff  s >= t_far

    (``thr``, ``far``: :func:`bin_thresholds`; q_bins - 1 radial ones)."""
    radial, far = bin_thresholds(radius, q_bins)
    t_in = _first_sq(_out_of_range(np.float32(radius)))
    t_radial = tuple(_first_sq(lambda d3, t=np.float32(t): d3 >= t)
                     for t in radial)
    t_far = _first_sq(lambda d3: d3 > np.float32(far))
    return t_in, t_radial, t_far


def bins_822(dx, dy, dz, d3, radius, kernel, group_axis=None):
    """Compare-only spherical bins of the (8, 2, q) kernel family.

    Returns the stored id minus one: the ref bin (0 = self loop,
    ``1 + q*16 + p*8 + n``) or, with ``group_axis`` ((B, 1, 1, 1)
    broadcastable int), its sort-grouped renumbering — G0 left-outer,
    G1 left-inner + self, G2 right-inner, G3 right-outer along the sort
    axis (``ops.dense._grouped_perm`` maps them back)."""
    n_bins, p_bins, q_bins = kernel
    if (n_bins, p_bins) != (8, 2):
        raise NotImplementedError("compare-only bins need an (8, 2, q) kernel")
    ux = -dx
    uy = -dy
    ax = ux.abs()
    ay = uy.abs()
    i32 = torch.int32

    def sel(c, a, b):
        return torch.where(c, a, b).to(i32)

    o_pos = torch.where(ux > 0, sel(ay < ax, 0, 1), sel(ay > ax, 2, 3))
    o_pos = torch.where((uy == 0) & (ux < 0), 4, o_pos).to(i32)
    o_neg = torch.where(ux < 0, sel(ay < ax, 4, 5), sel(ay > ax, 6, 7))
    n_id = torch.where(uy >= 0, o_pos, o_neg)
    # dx == dy == +-0: atan2's signed-zero convention decides the bin
    # (atan2(+-0, +0) -> bin 4, atan2(+-0, -0) -> bin 0)
    n_id = torch.where(
        (ax == 0) & (ay == 0), sel(torch.signbit(dx), 0, 4), n_id
    )
    p_id = (dz >= 0).to(i32)
    radial, far = bin_thresholds(radius, q_bins)
    q_id = torch.zeros_like(n_id)
    for thr in radial:
        q_id = q_id + (d3 >= thr).to(i32)
    if group_axis is None:
        bins = q_id * (p_bins * n_bins) + p_id * n_bins + n_id + 1
        return torch.where(d3 > far, bins, 0).to(i32)
    hemi_x = (n_id >= 2) & (n_id <= 5)
    hemi_y = n_id >= 4
    hemi_z = p_id == 1
    hemi = torch.where(
        group_axis == 2, hemi_z, torch.where(group_axis == 0, hemi_x, hemi_y)
    )
    i4x = torch.where(hemi, n_id - 2, (n_id + 2) & 7)
    i4y = torch.where(hemi, n_id - 4, n_id)
    inhemi = torch.where(
        group_axis == 2, n_id,
        p_id * 4 + torch.where(group_axis == 0, i4x, i4y),
    )
    outer = q_id == (q_bins - 1)
    gid_l = torch.where(outer, 1 + inhemi, 9 + q_id * 8 + inhemi)
    gid_r = torch.where(
        outer, (16 * q_bins - 6) + inhemi, (8 * q_bins + 2) + q_id * 8 + inhemi
    )
    gid = torch.where(hemi, gid_r, gid_l)
    return torch.where(d3 > far, gid - 1, 8 * q_bins).to(i32)


def _check_kernel(kernel) -> None:
    if kernel is None:
        return
    n_bins, p_bins, q_bins = kernel
    if (n_bins, p_bins) != (8, 2) or not 1 <= q_bins <= _MAX_Q_BINS:
        raise NotImplementedError(
            f"the dense query supports (8, 2, q<={_MAX_Q_BINS}) kernels, "
            f"got {kernel}"
        )


def dense_query(
    db_p: torch.Tensor,
    q_p: torch.Tensor,
    s_blk: torch.Tensor,
    u_end: torch.Tensor,
    axis: torch.Tensor | None,
    *,
    radius: float,
    k: int,
    kernel: tuple[int, int, int] | None,
    window: int,
    need_dist: bool = False,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Packed maps of one level graph.

    Args:
      db_p: (B, N_pad, 3) f32 database, TILE-padded with 2e9 sentinels.
      q_p:  (B, M_pad, 3) f32 queries, TILE-padded with 1e9 sentinels.
      s_blk: (B, nT) int window start per query tile, in TILE rows.
      u_end: (B, nT) int count of window chunks that can hold candidates
        (clamped to [1, W/TILE] by either version).
      axis: (B,) per-cloud sort axis for SORT-GROUPED bin ids, or None.
      radius, k, kernel, window: as ``ops.dense.build_dense_graph``.
      need_dist: also return the f32 distance map.

    Returns:
      (packed (B, nT, TILE, W) int8, count (B, M_pad) int32: each query
      row's selected entries, the nonzero bytes of its map row, dist):
      ``dist`` is the f32 (B, nT, TILE, W) distance map with
      ``need_dist``, else None.
    """
    _check_kernel(kernel)
    if not 1 <= k <= 127:
        raise ValueError(f"int8 maps need 1 <= K <= 127, got {k}")
    args = (db_p, q_p, s_blk, u_end, axis)
    kw = dict(radius=radius, k=k, kernel=kernel, window=window)
    if need_dist:
        kw["need_dist"] = True
    _build.record("dense_query", *args, **kw)
    if _build.use_kernel(db_p, use_kernels):
        return dense_query_kernel(*args, **kw)
    return dense_query_plain(*args, **kw)


def dense_query_plain(db_p, q_p, s_blk, u_end, axis, *, radius, k, kernel,
                      window, need_dist=False):
    """Plain PyTorch query, chunked over tiles to bound memory."""
    batch, m_pad, _ = q_p.shape
    n_t = m_pad // TILE
    g_all = batch * n_t
    dev = db_p.device
    cols = torch.arange(window, device=dev)
    rows = (s_blk.reshape(g_all, 1).long() * TILE + cols)      # (G, W)
    b_of_g = torch.arange(batch, device=dev).repeat_interleave(n_t)
    q_t = q_p.reshape(g_all, TILE, 3)
    u_end = u_end.clamp(1, window // TILE)
    live = cols[None, :] < u_end.reshape(g_all, 1).long() * TILE
    r32 = torch.tensor(radius, dtype=torch.float32, device=dev)
    out = torch.empty((g_all, TILE, window), dtype=torch.int8, device=dev)
    dist = (torch.empty((g_all, TILE, window), dtype=torch.float32,
                        device=dev) if need_dist else None)
    step = max(1, _PLAIN_BUDGET // (TILE * window))
    for g0 in range(0, g_all, step):
        sl = slice(g0, g0 + step)
        win = db_p[b_of_g[sl, None], rows[sl]]                  # (g, W, 3)
        q = q_t[sl]
        dx = win[:, None, :, 0] - q[:, :, None, 0]
        dy = win[:, None, :, 1] - q[:, :, None, 1]
        dz = win[:, None, :, 2] - q[:, :, None, 2]
        d3 = torch.sqrt(dx * dx + dy * dy + dz * dz)
        in_r = (d3 < r32) & ((d3 - r32).abs() > _BOUNDARY_EPS)
        in_r &= live[sl, None, :]
        rank = torch.cumsum(in_r.to(torch.int32), dim=-1)
        keep = in_r & (rank <= k)
        if kernel is None:
            val = rank
        else:
            ga = None
            if axis is not None:
                ga = axis.long()[b_of_g[sl]].reshape(-1, 1, 1)
            val = bins_822(dx, dy, dz, d3, radius, kernel, ga) + 1
        out[sl] = torch.where(keep, val, 0).to(torch.int8)
        if need_dist:
            dist[sl] = torch.where(keep, torch.sqrt(d3), 0.0)
    if need_dist:
        dist = dist.reshape(batch, n_t, TILE, window)
    count = (out > 0).sum(dim=-1, dtype=torch.int32).reshape(batch, m_pad)
    return out.reshape(batch, n_t, TILE, window), count, dist


def dense_query_kernel(db_p, q_p, s_blk, u_end, axis, *, radius, k, kernel,
                       window, need_dist=False):
    """The query through ``csrc/dense_query.cu``: :func:`query_split`
    blocks per (cloud, query tile), each staging the window's
    coordinates in shared memory, one warp per query row testing 128
    columns a step against the squared-distance thresholds of
    :func:`query_thresholds`; the same launch writes the rows' counts
    and, with ``need_dist``, the distance map. ``s_blk`` and ``u_end``
    are read as the plan holds them (int64), ``axis`` (int32) only for
    grouped bins: one device launch a call."""
    _build.check(db_p, "db_p", torch.float32, 3)
    _build.check(q_p, "q_p", torch.float32, 3)
    batch, n_pad, _ = db_p.shape
    m_pad = q_p.shape[1]
    n_t = m_pad // TILE
    if m_pad % TILE or n_pad % TILE or window % TILE or window > n_pad:
        raise ValueError("query shapes must be TILE-padded with W <= N_pad")
    if 12 * window > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"window {window} exceeds the kernel's shared memory")
    if s_blk.shape != (batch, n_t) or u_end.shape != (batch, n_t):
        raise ValueError("s_blk / u_end must be (B, nT)")
    sb = s_blk.to(torch.int64).contiguous()   # the plan's, as it is
    ue = u_end.to(torch.int64).contiguous()
    _build.check(sb, "s_blk", torch.int64, 2)
    _build.check(ue, "u_end", torch.int64, 2)
    ax = None
    if kernel is None:
        mode, q_bins = 0, 1
    else:
        mode, q_bins = (2 if axis is not None else 1), kernel[2]
    if mode == 2:
        ax = axis.to(torch.int32).contiguous()    # the plan's, as it is
        _build.check(ax, "axis", torch.int32, 1)
        if ax.shape != (batch,):
            raise ValueError("axis must be (B,)")
    t_in, t_radial, t_far = query_thresholds(radius, q_bins)
    t_radial = (list(t_radial) + [0.0] * _MAX_Q_BINS)[: _MAX_Q_BINS - 1]
    dev = db_p.device
    out = torch.empty((batch, n_t, TILE, window), dtype=torch.int8,
                      device=dev)
    count = torch.empty((batch, m_pad), dtype=torch.int32, device=dev)
    dist = (torch.empty((batch, n_t, TILE, window), dtype=torch.float32,
                        device=dev) if need_dist else None)
    QUERY_KERNEL.launch(
        _build.ptr(db_p), _build.ptr(q_p), _build.ptr(sb), _build.ptr(ue),
        None if ax is None else _build.ptr(ax), _build.ptr(out),
        None if dist is None else _build.ptr(dist), _build.ptr(count),
        batch, n_pad, n_t, window, k, mode, q_bins, query_split(batch * n_t),
        t_in, *t_radial, t_far, _build.stream(db_p),
    )
    return out, count, dist


def growth_radii(radius: float, growth_steps: int) -> np.ndarray:
    """The G+1 radii of the growth query, a running f32 sum as the JAX
    kernel builds them: r_0 = f32(radius), r_{i+1} = f32(r_i + f32(0.05))
    (``query_kernel.py:471-475``)."""
    radii = [np.float32(radius)]
    for _ in range(growth_steps):
        radii.append(np.float32(radii[-1] + np.float32(GROWTH_STEP)))
    return np.array(radii, np.float32)


@functools.lru_cache(maxsize=None)
def growth_thresholds(radius: float, growth_steps: int) -> tuple[float, ...]:
    """The growth query's squared-distance thresholds: for each radius
    ``r_i`` of :func:`growth_radii`, ``t_i`` with ``d3 = sqrt(s)`` in range
    at ``r_i`` iff ``s < t_i`` (ascending, as the radii)."""
    return tuple(_first_sq(_out_of_range(r))
                 for r in growth_radii(radius, growth_steps))


def growth_query(
    db_p: torch.Tensor,
    q_p: torch.Tensor,
    s_blk: torch.Tensor,
    u_end: torch.Tensor,
    *,
    radius: float,
    k: int,
    window: int,
    growth_steps: int,
    need_dist: bool = False,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor | None]:
    """Rank maps of a selection-only graph whose zero-neighbor queries
    grow their radius by +0.05 (ref tf_nnquery_gpu.cu:30-60), densely
    in-window, for up to ``growth_steps`` steps.

    With radii r_0..r_G (:func:`growth_radii`) and, for a query row and
    each live window column w, ``g(w)`` = the number of radii at which w
    is NOT in range (strict ``<`` with the 1e-6 margin): the row's step is
    ``g* = min(G+1, min_w g(w))``, the row is alive iff ``g* <= G``, and it
    selects the columns with ``g(w) <= g*`` (the in-range set at radius
    ``r_{g*}``), the first K of them in window order, as ranks 1..K.

    Args: as :func:`dense_query` (no bins: ``kernel`` is None), plus
      ``growth_steps`` G in 1..15.

    Returns:
      (packed (B, nT, TILE, W) int8 ranks, steps (B, nT, TILE) int8: each
      row's growth step, 0 for rows that select nothing, count (B, M_pad)
      int32: each row's selected entries, dist): ``dist`` is the f32
      (B, nT, TILE, W) distance map of the selected columns at each row's
      grown radius with ``need_dist``, else None.
    """
    if not 1 <= k <= 127:
        raise ValueError(f"int8 maps need 1 <= K <= 127, got {k}")
    if not 1 <= growth_steps <= _MAX_GROWTH:
        raise ValueError(
            f"growth_steps must be in 1..{_MAX_GROWTH}, got {growth_steps}")
    args = (db_p, q_p, s_blk, u_end)
    kw = dict(radius=radius, k=k, window=window, growth_steps=growth_steps)
    if need_dist:
        kw["need_dist"] = True
    _build.record("growth_query", *args, **kw)
    if _build.use_kernel(db_p, use_kernels):
        return growth_query_kernel(*args, **kw)
    return growth_query_plain(*args, **kw)


def growth_query_plain(db_p, q_p, s_blk, u_end, *, radius, k, window,
                       growth_steps, need_dist=False):
    """Plain PyTorch growth query, chunked over tiles to bound memory."""
    batch, m_pad, _ = q_p.shape
    n_t = m_pad // TILE
    g_all = batch * n_t
    dev = db_p.device
    cols = torch.arange(window, device=dev)
    rows = (s_blk.reshape(g_all, 1).long() * TILE + cols)      # (G, W)
    b_of_g = torch.arange(batch, device=dev).repeat_interleave(n_t)
    q_t = q_p.reshape(g_all, TILE, 3)
    u_end = u_end.clamp(1, window // TILE)
    live = cols[None, :] < u_end.reshape(g_all, 1).long() * TILE
    radii = torch.from_numpy(growth_radii(radius, growth_steps)).to(dev)
    never = growth_steps + 1
    out = torch.empty((g_all, TILE, window), dtype=torch.int8, device=dev)
    steps = torch.empty((g_all, TILE), dtype=torch.int8, device=dev)
    dist = (torch.empty((g_all, TILE, window), dtype=torch.float32,
                        device=dev) if need_dist else None)
    step = max(1, _PLAIN_BUDGET // (TILE * window))
    for g0 in range(0, g_all, step):
        sl = slice(g0, g0 + step)
        win = db_p[b_of_g[sl, None], rows[sl]]                  # (g, W, 3)
        q = q_t[sl]
        dx = win[:, None, :, 0] - q[:, :, None, 0]
        dy = win[:, None, :, 1] - q[:, :, None, 1]
        dz = win[:, None, :, 2] - q[:, :, None, 2]
        d3 = torch.sqrt(dx * dx + dy * dy + dz * dz)
        g_cand = torch.zeros(d3.shape, dtype=torch.int32, device=dev)
        for r in radii:
            in_r = (d3 < r) & ((d3 - r).abs() > _BOUNDARY_EPS)
            g_cand += (~in_r).to(torch.int32)
        g_cand = torch.where(live[sl, None, :], g_cand, never)
        gstar = g_cand.amin(dim=-1, keepdim=True)               # (g, T, 1)
        alive = gstar < never
        in_g = (g_cand <= gstar) & alive
        rank = torch.cumsum(in_g.to(torch.int32), dim=-1)
        keep = in_g & (rank <= k)
        out[sl] = torch.where(keep, rank, 0).to(torch.int8)
        steps[sl] = torch.where(alive, gstar, 0)[..., 0].to(torch.int8)
        if need_dist:
            dist[sl] = torch.where(keep, torch.sqrt(d3), 0.0)
    if need_dist:
        dist = dist.reshape(batch, n_t, TILE, window)
    count = (out > 0).sum(dim=-1, dtype=torch.int32).reshape(batch, m_pad)
    return (out.reshape(batch, n_t, TILE, window),
            steps.reshape(batch, n_t, TILE), count, dist)


def growth_query_kernel(db_p, q_p, s_blk, u_end, *, radius, k, window,
                        growth_steps, need_dist=False):
    """The growth query through ``csrc/growth_query.cu``:
    :func:`query_split` blocks per (cloud, query tile), each staging the
    live window in shared memory, one warp per query row; pass 1 finds
    the row's least squared distance
    (hence its step, against :func:`growth_thresholds`) with a warp min,
    pass 2 ranks the columns within the row's grown radius as K2 does,
    writing the map, the rows' steps and counts (and, with
    ``need_dist``, the distance map). ``s_blk``, ``u_end`` read in place
    (int64): one device launch a call."""
    _build.check(db_p, "db_p", torch.float32, 3)
    _build.check(q_p, "q_p", torch.float32, 3)
    batch, n_pad, _ = db_p.shape
    m_pad = q_p.shape[1]
    n_t = m_pad // TILE
    if m_pad % TILE or n_pad % TILE or window % TILE or window > n_pad:
        raise ValueError("query shapes must be TILE-padded with W <= N_pad")
    if 12 * window > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(f"window {window} exceeds the kernel's shared memory")
    if s_blk.shape != (batch, n_t) or u_end.shape != (batch, n_t):
        raise ValueError("s_blk / u_end must be (B, nT)")
    sb = s_blk.to(torch.int64).contiguous()   # the plan's, as it is
    ue = u_end.to(torch.int64).contiguous()
    _build.check(sb, "s_blk", torch.int64, 2)
    _build.check(ue, "u_end", torch.int64, 2)
    # the launcher copies the thresholds from this host array into the
    # kernel's parameters
    thresholds = _THRESHOLDS(*growth_thresholds(radius, growth_steps))
    dev = db_p.device
    out = torch.empty((batch, n_t, TILE, window), dtype=torch.int8,
                      device=dev)
    steps = torch.empty((batch, n_t, TILE), dtype=torch.int8, device=dev)
    count = torch.empty((batch, m_pad), dtype=torch.int32, device=dev)
    dist = (torch.empty((batch, n_t, TILE, window), dtype=torch.float32,
                        device=dev) if need_dist else None)
    GROWTH_KERNEL.launch(
        _build.ptr(db_p), _build.ptr(q_p), _build.ptr(sb), _build.ptr(ue),
        _build.ptr(out), _build.ptr(steps), _build.ptr(count),
        None if dist is None else _build.ptr(dist), thresholds,
        batch, n_pad, n_t, window, k, growth_steps + 1,
        query_split(batch * n_t), _build.stream(db_p),
    )
    return out, steps, count, dist
