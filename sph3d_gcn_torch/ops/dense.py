"""Dense windowed neighborhoods: graphs as (tile x window) maps
(counterpart of ``sph3d_gcn_tpu/ops/dense.py``).

For axis-sorted clouds every in-range neighbor of a 128-query tile lies in
a contiguous window of W database rows. A level graph is then one int8 map
``packed[b, tile, t, w]``: 0 where column w is not a selected neighbor of
query t, else the neighbor's filter bin + 1 (conv graphs) or its rank
1..K in point order (selection-only pool graphs). Consumers never see an
edge index list:

  conv   out[t, c*r+j] = sum_w x[win(w), c] * filt[packed[t,w]-1, c, j]
                         / max(count[t], 1)
  pool   out[t, c]     = max (or mean) over selected w of x[win(w), c]
                         (0 if none)
  unpool out[t, c]     = mean over selected w of x[win(w), c], or the
                         distance-weighted sum (``dist`` maps)

The certificate ``ok`` (JAX: ``DenseNeighborhood.ok``) is True when the
provable window bound held: the database is sorted along some axis and
every tile's [min - r, max + r] slab fits its window. Results then equal
the classic per-edge ops exactly. On request the query also writes an f32
distance map beside the packed one (``DenseNeighborhood.dist``), which
the weighted unpool and IDS sampling read.

Kernels: the query and the growth query are ``ops/query.py``; the conv
(``csrc/dense_conv.cu``), its backward (``csrc/dense_conv_bwd.cu``), the
rank pool (``csrc/rank_pool.cu``, with the first attaining column when a
gradient is wanted) and its backward (``csrc/rank_pool_bwd.cu``) are
wrapped here, each beside its plain PyTorch version. The conv and the pool are
``torch.autograd.Function``s whose backward runs the backward kernel (or,
for a CPU tensor, its plain version): both backwards give every output
row one owner and sum in a fixed order, so gradients are bitwise
reproducible. The masked-mean unpool, the avg pool (the same masked mean)
and the distance-weighted unpool are a batched matmul over the gathered
windows (the JAX package leaves them to XLA as well); their backward
is the per-edge engine's segment sum in its second form
(``csrc/window_gather_bwd.cu``, ``ops/windowed.py``), which forms the
window gradients from the map and sums them into the cloud, again one
owner per row. ``dense_max_pool3d(with_index=True)``
(the op-level ``max_index``) runs the pool kernel with its first
attaining column.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from sph3d_gcn_torch import _build
from sph3d_gcn_torch.ops import windowed
from sph3d_gcn_torch.ops.conv import einsum_f32
from sph3d_gcn_torch.ops.query import (
    GROWTH_STEP,
    TILE,
    dense_query,
    growth_query,
)

# element budget of the plain conv's one-hot and the plain pool's
# candidate block per tile chunk (f32: 256 MB)
_PLAIN_BUDGET = 1 << 26
_MAX_CONV_C = 1024     # the conv kernel
_MAX_POOL_C = 512      # the pool kernel, and so its backward
# the pool kernel's window: a warp's list of selected columns (2 bytes
# each) for each of a block's 8 rows in shared memory
_MAX_POOL_WINDOW = 12288
_MAX_CONV_BWD_C = 1024  # the conv backward kernel

CONV_KERNEL = _build.register(
    "dense_conv", "sph3d_dense_conv_launch",
    [_build.PTR] * 4 + [_build.LONG] + [_build.PTR] * 2 + [_build.INT] * 12
    + [_build.PTR],
)
POOL_KERNEL = _build.register(
    "rank_pool", "sph3d_rank_pool_launch",
    [_build.PTR] * 3 + [_build.INT] * 2 + [_build.PTR] * 4
    + [_build.INT] * 7 + [_build.PTR],
)
# the conv backward launches three kernels a call: the dfilt partials of
# each query tile, their sum over tiles, and dx
CONV_BWD_KERNEL = _build.register(
    "dense_conv_bwd", "sph3d_dense_conv_bwd_launch",
    [_build.PTR] * 9 + [_build.INT] * 12 + [_build.PTR], per_call=3,
)
POOL_BWD_KERNEL = _build.register(
    "rank_pool_bwd", "sph3d_rank_pool_bwd_launch",
    [_build.PTR] * 4 + [_build.INT] * 6 + [_build.PTR],
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class DenseNeighborhood:
    """A level graph as dense per-candidate maps.

    Attributes:
      packed: (B, nT, TILE, W) int8 — 0 where the candidate is not a
        selected neighbor, else ``filter_bin + 1``; with ``kernel=None``
        the neighbor's RANK 1..k_max in window order.
      s_blk:  (B, nT) int64 window start in TILE rows.
      count:  (B, M) int32 = min(in-range count, nn_sample).
      ok:     () bool tensor — the window-coverage certificate.
      dist:   (B, nT, TILE, W) f32 sqrt-space distance of each selected
              entry, 0 elsewhere; None unless the graph was built with
              ``need_dist`` (IDS sampling, the weighted unpool).
      axis:   (B,) int32 per-cloud sort axis (grouped bin maps only).
      num_query, num_db: M and N.
      k_max:  K when ``packed`` holds ranks, else 0.
      grouped: True when ``packed`` holds SORT-GROUPED bin ids.
    """

    packed: torch.Tensor
    s_blk: torch.Tensor
    count: torch.Tensor
    ok: torch.Tensor
    dist: torch.Tensor | None = None
    axis: torch.Tensor | None = None
    num_query: int = 0
    num_db: int = 0
    k_max: int = 0
    grouped: bool = False

    @property
    def window(self) -> int:
        return self.packed.shape[-1]


def _sorted_axis_ok(db: torch.Tensor):
    """(key (B, N), axis (B,), all-clouds-sorted flag) — the first axis
    along which each cloud is sorted (axis 0 and flag False if none)."""
    diffs = db[:, 1:, :] >= db[:, :-1, :]
    axis_sorted = diffs.all(dim=1)                       # (B, 3)
    axis = torch.argmax(axis_sorted.to(torch.int32), dim=-1)
    key = torch.gather(
        db, 2, axis[:, None, None].expand(-1, db.shape[1], 1)
    )[..., 0]
    return key, axis, axis_sorted.any(dim=-1).all()


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """The inputs of one graph's dense query (``ops.query.dense_query``)
    and its window-coverage certificate before the zero-count check."""

    db_p: torch.Tensor       # (B, N_pad, 3) f32, 2e9 sentinel padding
    q_p: torch.Tensor        # (B, M_pad, 3) f32, 1e9 sentinel padding
    s_blk: torch.Tensor      # (B, nT) window start in TILE rows
    u_end: torch.Tensor      # (B, nT) live window chunks past s_blk
    axis: torch.Tensor | None  # (B,) sort axis for grouped bin ids
    ok: torch.Tensor         # () bool: sorted and every slab covered
    window: int              # W after rounding and clamping
    num_query: int
    num_db: int
    key_p: torch.Tensor      # (B, N_pad) sort-axis keys, 2e9 padding
    tile_min: torch.Tensor   # (B, nT) query tiles' sort-axis extent
    tile_max: torch.Tensor


def plan_dense_query(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float,
    kernel: tuple[int, int, int] | None,
    window: int,
    growth_steps: int = 0,
    query_shard: tuple[int, int] | None = None,
) -> QueryPlan:
    """Padding, per-tile window starts and slab ends, and the provable
    coverage certificate of one dense graph (the JAX op's XLA part). With
    ``growth_steps`` the window starts one block lower and the slab end
    is taken at the largest grown radius; the grown slab is re-certified
    after the query (:func:`build_dense_graph`). ``query_shard``
    (rank, shards): only that rank's chunk of the query tiles (the plan's
    ``q_p``, bounds and certificate cover those tiles alone)."""
    db = database[..., :3].float()
    q = query[..., :3].float()
    batch, num_db, _ = db.shape
    num_q = q.shape[1]
    radius = float(radius)
    n_pad = _round_up(num_db, TILE)
    w = min(_round_up(window, TILE), n_pad)
    m_pad = _round_up(num_q, TILE)
    n_t = m_pad // TILE

    # far sentinels: padded database rows are never in range, padded
    # query rows select nothing
    db_p = F.pad(db, (0, 0, 0, n_pad - num_db), value=2e9)
    q_p = F.pad(q, (0, 0, 0, m_pad - num_q), value=1e9)
    if query_shard is not None:
        # every bound and map below is per query tile: slicing the
        # queries shrinks all of it to this rank's tiles
        rank, shards = query_shard
        if n_t % shards:
            raise ValueError(
                f"{n_t} query tiles do not split over {shards} shards")
        if num_q != m_pad:
            raise ValueError(f"query_shard needs a TILE-aligned query "
                             f"count, got {num_q} (pad to {m_pad})")
        n_t //= shards
        m_pad = num_q = n_t * TILE
        q_p = q_p[:, rank * m_pad:(rank + 1) * m_pad].contiguous()

    key, axis, is_sorted = _sorted_axis_ok(db)
    key_p = F.pad(key, (0, n_pad - num_db), value=2e9)
    q_key = torch.gather(
        q_p, 2, axis[:, None, None].expand(-1, m_pad, 1)
    )[..., 0].reshape(batch, n_t, TILE)
    real = (torch.arange(m_pad, device=db.device) < num_q).reshape(n_t, TILE)
    has_real = real.any(dim=-1)                          # (nT,)
    inf = torch.tensor(float("inf"), device=db.device)
    tile_min = torch.where(real, q_key, inf).amin(dim=-1)
    tile_max = torch.where(real, q_key, -inf).amax(dim=-1)
    tile_min = torch.where(has_real, tile_min, 2e9)
    tile_max = torch.where(has_real, tile_max, -2e9)

    # provable slab bounds via compare-counts on the sorted key
    lo = tile_min[..., None] - radius
    hi = tile_max[..., None] + radius
    s_row = (key_p[:, None, :] < lo).sum(dim=-1)         # (B, nT)
    e_row = (key_p[:, None, :] <= hi).sum(dim=-1)
    s_start = s_row // TILE
    if growth_steps:
        # growth widens the slab on both sides: start one block lower
        s_start = s_start - 1
    s_blk = torch.clamp(s_start, 0, (n_pad - w) // TILE)
    ok = is_sorted & (e_row - s_blk * TILE <= w).all()
    if growth_steps:
        hi_m = tile_max[..., None] + (radius + GROWTH_STEP * growth_steps)
        e_row = (key_p[:, None, :] <= hi_m).sum(dim=-1)
    # per-tile slab END in TILE chunks past s_blk (at the largest grown
    # radius): later chunks provably hold no in-range candidate and are
    # zero-filled
    u_end = -torch.div(-(e_row - s_blk * TILE), TILE, rounding_mode="floor")
    grouped = kernel is not None and tuple(kernel[:2]) == (8, 2)
    return QueryPlan(
        db_p=db_p, q_p=q_p, s_blk=s_blk, u_end=u_end,
        axis=axis.to(torch.int32) if grouped else None, ok=ok, window=w,
        num_query=num_q, num_db=num_db, key_p=key_p, tile_min=tile_min,
        tile_max=tile_max,
    )


def build_dense_graph(
    database: torch.Tensor,
    query: torch.Tensor,
    radius: float,
    nn_sample: int,
    kernel: tuple[int, int, int] | None,
    window: int,
    self_graph: bool = False,
    need_dist: bool = False,
    growth_steps: int = 0,
    query_shard=None,
    use_kernels: bool | None = None,
) -> DenseNeighborhood:
    """Dense windowed counterpart of ``build_sphere_neighbor_and_bins``.

    Args:
      database: (B, N, 3+) axis-sorted coordinates.
      query:    (B, M, 3+) coordinates (the database itself for intra
                graphs).
      radius:   search radius (strict ``<`` with the 1e-6 margin).
      nn_sample: K — the first K in point order are kept.
      kernel:   (8, 2, q) spherical kernel (bins, sort-grouped), or None
                for selection-only rank maps.
      window:   W, rounded up to 128 and clamped to the padded cloud.
      self_graph: the query is the database (every row selects itself, so
                the zero-count check is skipped).
      growth_steps: reproduce the reference's +0.05 radius growth of
                zero-neighbor queries (ref tf_nnquery_gpu.cu:30-60) for up
                to this many steps, densely in-window: each row selects at
                its first radius with a candidate in range
                (``ops.query.growth_query``). The certificate then also
                checks each tile's slab at its grown radius. Selection-only
                graphs (``kernel=None``) only.
      need_dist: also build the f32 distance map (``dist``), in the same
                query launch (at each row's grown radius with growth).
      query_shard: (rank, shards) under point sharding: only that point
                rank's chunk of the query tiles is built (the queries, the
                slab bounds and the maps shrink 1/shards; the database
                stays whole). The fields are then tile-local, ``s_blk``
                still in the whole database's blocks (rebase it with
                ``parallel.spatial.local_neighborhood`` for haloed
                features), ``count`` and ``num_query`` the rank's padded
                rows, and ``ok`` certifies its tiles only (the models
                combine the ranks' certificates). The query tiles must
                split evenly and the query count be TILE-aligned.

    Returns:
      DenseNeighborhood.
    """
    if growth_steps and kernel is not None:
        raise ValueError(
            "growth_steps is only supported for selection-only graphs "
            "(kernel=None); intra graphs self-include and never grow"
        )
    plan = plan_dense_query(database, query, radius, kernel, window,
                            growth_steps, query_shard)
    k = int(nn_sample)
    if growth_steps:
        packed, steps, count, dist = growth_query(
            plan.db_p, plan.q_p, plan.s_blk, plan.u_end, radius=radius, k=k,
            window=plan.window, growth_steps=growth_steps,
            need_dist=need_dist, use_kernels=use_kernels,
        )
    else:
        packed, count, dist = dense_query(
            plan.db_p, plan.q_p, plan.s_blk, plan.u_end, plan.axis,
            radius=radius, k=k, kernel=kernel, window=plan.window,
            need_dist=need_dist, use_kernels=use_kernels,
        )
    count = count[:, :plan.num_query]
    ok = plan.ok
    if growth_steps:
        # selections at a tile's grown radius are exact only if the grown
        # slab still lies inside the window gathered at the base radius
        gmax = steps.amax(dim=-1).float()                # (B, nT)
        r_eff = radius + GROWTH_STEP * gmax
        lo_g = plan.tile_min - r_eff
        hi_g = plan.tile_max + r_eff
        s_row_g = (plan.key_p[:, None, :] < lo_g[..., None]).sum(dim=-1)
        e_row_g = (plan.key_p[:, None, :] <= hi_g[..., None]).sum(dim=-1)
        start = plan.s_blk * TILE
        ok = ok & ((s_row_g >= start)
                   & (e_row_g - start <= plan.window)).all()
    if not self_graph:
        # the reference grows the radius of zero-neighbor queries; dense
        # mode reports that case through ok=False instead
        ok = ok & (count > 0).all()
    return DenseNeighborhood(
        packed=packed,
        s_blk=plan.s_blk,
        count=count,
        ok=ok,
        dist=dist,
        axis=plan.axis,
        num_query=plan.num_query,
        num_db=plan.num_db,
        k_max=k if kernel is None else 0,
        grouped=plan.axis is not None,
    )


@functools.lru_cache(maxsize=None)
def _grouped_perm(f_bins: int) -> np.ndarray:
    """(3, F) int64: [sort_axis, grouped_row] -> ref bin row, mirroring the
    sort-grouped renumbering of ``ops.query.bins_822``. Ref row 0 is the
    self bin; row 1 + q*16 + p*8 + n the (n, p, q) bin."""
    q_bins = (f_bins - 1) // 16
    perm = np.zeros((3, f_bins), np.int64)
    for a in range(3):
        perm[a, 8 * q_bins] = 0                      # self -> G1 tail
        for r in range(1, f_bins):
            e = r - 1
            n_id, p_id, q_id = e % 8, (e // 8) % 2, e // 16
            if a == 2:
                hemi = p_id == 1
                inhemi = n_id
            elif a == 0:
                hemi = 2 <= n_id <= 5
                inhemi = p_id * 4 + (n_id - 2 if hemi else (n_id + 2) % 8)
            else:
                hemi = n_id >= 4
                inhemi = p_id * 4 + (n_id - 4 if hemi else n_id)
            outer = q_id == q_bins - 1
            if not hemi:
                gid = 1 + inhemi if outer else 9 + q_id * 8 + inhemi
            else:
                gid = (
                    (16 * q_bins - 6) + inhemi
                    if outer
                    else (8 * q_bins + 2) + q_id * 8 + inhemi
                )
            perm[a, gid - 1] = r
    perm.setflags(write=False)
    return perm


def _window_rows(packed, s_blk, num_in):
    """Per tile, the cloud row of every window column, and the tile's
    cloud: ((G, W) rows clamped to the cloud, (G, W) in-cloud mask,
    (G,) batch index)."""
    batch, n_t, _, w = packed.shape
    dev = packed.device
    rows = s_blk.reshape(batch * n_t, 1).long() * TILE + torch.arange(
        w, device=dev
    )
    b_of_g = torch.arange(batch, device=dev).repeat_interleave(n_t)
    return rows.clamp(max=num_in - 1), rows < num_in, b_of_g


def dense_conv_plain(packed, s_blk, inputs, filt_b, inv):
    """Plain PyTorch depthwise conv from packed bin maps, in f32.

    A one-hot (tiles, TILE, W, F) bin matrix contracts the window
    features per bin, chunked over tiles so memory stays bounded.
    Returns (B, M_pad, C*r) in the input dtype."""
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    f_bins, mult = filt_b.shape[1], filt_b.shape[3]
    rows, valid, b_of_g = _window_rows(packed, s_blk, num_in)
    pk = packed.reshape(batch * n_t, TILE, w)
    inv_t = inv.reshape(batch * n_t, TILE)
    fids = torch.arange(1, f_bins + 1, device=packed.device,
                        dtype=torch.int8)
    out = torch.empty((batch * n_t, TILE, c * mult), dtype=inputs.dtype,
                      device=inputs.device)
    step = max(1, _PLAIN_BUDGET // (TILE * w * f_bins))
    for g0 in range(0, batch * n_t, step):
        sl = slice(g0, g0 + step)
        xw = inputs[b_of_g[sl, None], rows[sl]].float()         # (g, W, C)
        xw = torch.where(valid[sl, :, None], xw, 0.0)
        onehot = (pk[sl, :, :, None] == fids).float()          # (g,T,W,F)
        s = torch.einsum("gtwf,gwc->gtfc", onehot, xw)
        o = torch.einsum("gtfc,gfcr->gtcr", s, filt_b[b_of_g[sl]])
        out[sl] = (o * inv_t[sl, :, None, None]).reshape(
            -1, TILE, c * mult
        ).to(inputs.dtype)
    return out.reshape(batch, n_t * TILE, c * mult)


# the conv kernel's 32-channel slot counts (csrc/dense_conv.cu builds
# these), the shared memory of its filter slice that leaves room for
# several blocks an SM, the items (a part of a tile for a slice of the
# channels) a call should give the card, and where its blocks persist: a
# filter slice of at least _PERSIST_FILTER_BYTES against fewer than
# _PERSIST_TILES query tiles
FWD_SLOTS = (1, 2, 3, 4, 5, 8)
_FWD_FILTER_BYTES = 36 * 1024
_FWD_BLOCKS = 4 * 132
_PERSIST_FILTER_BYTES = 24 * 1024
_PERSIST_TILES = 320


@functools.lru_cache(maxsize=None)
def conv_fwd_layout(c: int, mult: int, f_bins: int,
                    tiles: int) -> tuple[int, int, int, bool]:
    """How ``csrc/dense_conv.cu`` lays out its work for ``C`` channels (a
    lane holds a channel and its r sums; 32-lane slots), ``F`` bins and
    ``tiles`` = B * n_t query tiles: (slots, slices, split, persistent).

    An item of work is 128 / ``split`` rows of a tile for ``slots`` slots
    of one of ``slices`` slices of the channels (as even as the built slot
    counts allow): the widest slots whose (F, 32 slots, r) filter slice
    fits ``_FWD_FILTER_BYTES``, so a call reads the map once per slice,
    and the fewest parts that give the card ``_FWD_BLOCKS`` items (where
    even 8 parts fall short, narrower slices add items). A block takes one
    item, or, ``persistent``, the blocks that fit the card at once take
    the items in order and stage a filter slice once for each run of
    items of one cloud and slice: where the slice is large against the
    rows of the few tiles (the scene models' deep levels), staging it for
    every item cost more than the items (PERF.md). Cached: a call's host
    time counts on the small calls."""
    fits = [s for s in FWD_SLOTS
            if f_bins * 32 * s * mult * 4 <= _FWD_FILTER_BYTES] or [1]
    for top in reversed(fits):
        slices = -(-c // (32 * top))
        slots = next(s for s in FWD_SLOTS if 32 * s * slices >= c)
        if tiles * slices * 8 >= _FWD_BLOCKS:
            break
    split = next((s for s in (1, 2, 4) if tiles * slices * s >= _FWD_BLOCKS),
                 8)
    persistent = (tiles < _PERSIST_TILES and f_bins * 32 * slots * mult * 4
                  >= _PERSIST_FILTER_BYTES)
    return slots, slices, split, persistent


def dense_conv_kernel(packed, s_blk, inputs, filt_b, inv, layout=None):
    """The conv through ``csrc/dense_conv.cu``: a block per (query tile or
    part of one, cloud, channel slice) stages its filter slice in shared
    memory; each warp decodes its rows' map into a hit list and adds the
    hits a few at a time, ``x[row, c] * filt_b[bin, c, j]`` in f32 in
    window order. ``filt_b`` may be one filter expanded over the clouds
    (read in place, the ungrouped maps'); ``s_blk`` is read as the graph's
    int64. ``layout``: (slots, slices, split, persistent),
    :func:`conv_fwd_layout`'s by default (the tests pass others to reach
    every built variant)."""
    _build.check(packed, "packed", torch.int8, 4)
    _build.check(inputs, "inputs", (torch.float32, torch.bfloat16), 3)
    _build.check(inv, "inv", torch.float32, 2)
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    f_bins, mult = filt_b.shape[1], filt_b.shape[3]
    if not 1 <= c <= _MAX_CONV_C or mult not in (1, 2):
        raise ValueError(
            f"dense conv kernel takes C <= {_MAX_CONV_C} and a depth "
            f"multiplier of 1 or 2, got C={c}, r={mult}"
        )
    if filt_b.shape != (batch, f_bins, c, mult) or f_bins > 127:
        raise ValueError(f"bad per-cloud filter shape {tuple(filt_b.shape)}")
    if filt_b.stride(0) == 0:        # one filter expanded over the clouds
        _build.check(filt_b[0], "filt_b", torch.float32, 3)
    else:
        _build.check(filt_b, "filt_b", torch.float32, 4)
    if inv.shape != (batch, n_t * TILE):
        raise ValueError(f"bad inverse-count shape {tuple(inv.shape)}")
    if s_blk.shape != (batch, n_t):
        raise ValueError(f"bad window-start shape {tuple(s_blk.shape)}")
    s_blk = s_blk.to(torch.int64).contiguous()   # a graph's, as it is
    _build.check(s_blk, "s_blk", torch.int64, 2)
    slots, slices, split, persistent = layout or conv_fwd_layout(
        c, mult, f_bins, batch * n_t)
    packed = _aligned(packed)
    out = torch.empty((batch, n_t * TILE, c * mult), dtype=inputs.dtype,
                      device=inputs.device)
    CONV_KERNEL.launch(
        _build.ptr(packed), _build.ptr(s_blk), _build.ptr(inputs),
        _build.ptr(filt_b), filt_b.stride(0), _build.ptr(inv),
        _build.ptr(out),
        batch, n_t, num_in, c, f_bins, w, mult,
        int(inputs.dtype == torch.bfloat16), slots, slices, split,
        int(persistent), _build.stream(inputs),
    )
    return out


def dense_conv_bwd_plain(packed, s_blk, inputs, filt_b, inv, dout):
    """Plain PyTorch backward of the dense conv, in f32, chunked over tiles
    as :func:`dense_conv_plain` (differentiating that function instead
    would hold the one-hot of the whole cloud at once).

    With ``g = inv * dout`` per query row: ``dx`` sums, over the selected
    entries of each window row, ``g . filt_b[bin]`` and ``dfilt_b[b, f]``
    sums ``g * x[row]`` over cloud b's entries of bin f. Returns (dx
    (B, N, C) in the input dtype, rounded once; dfilt_b (B, F, C, r) f32).
    """
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    f_bins, mult = filt_b.shape[1], filt_b.shape[3]
    rows, valid, b_of_g = _window_rows(packed, s_blk, num_in)
    pk = packed.reshape(batch * n_t, TILE, w)
    g_all = dout.reshape(batch * n_t, TILE, c, mult).float() * inv.reshape(
        batch * n_t, TILE, 1, 1)
    fids = torch.arange(1, f_bins + 1, device=packed.device,
                        dtype=torch.int8)
    dx = torch.zeros((batch * num_in, c), dtype=torch.float32,
                     device=inputs.device)
    dfilt = torch.zeros((batch, f_bins, c, mult), dtype=torch.float32,
                        device=inputs.device)
    step = max(1, _PLAIN_BUDGET // (TILE * w * f_bins))
    for g0 in range(0, batch * n_t, step):
        sl = slice(g0, g0 + step)
        onehot = (pk[sl, :, :, None] == fids).float()          # (g,T,W,F)
        ds = torch.einsum("gtcr,gfcr->gtfc", g_all[sl], filt_b[b_of_g[sl]])
        dxw = torch.einsum("gtwf,gtfc->gwc", onehot, ds)
        xw = inputs[b_of_g[sl, None], rows[sl]].float()         # (g, W, C)
        xw = torch.where(valid[sl, :, None], xw, 0.0)
        s = torch.einsum("gtwf,gwc->gtfc", onehot, xw)
        dfilt.index_add_(0, b_of_g[sl],
                         torch.einsum("gtfc,gtcr->gfcr", s, g_all[sl]))
        flat = (b_of_g[sl, None] * num_in + rows[sl])[valid[sl]]
        dx.index_add_(0, flat, dxw[valid[sl]])
    return dx.reshape(batch, num_in, c).to(inputs.dtype), dfilt


# the card's SMs: the dx owners of a call should give each one at least a
# block, and the dfilt blocks four; the shared memory of the dx owner's
# filter slice and of the dfilt block's partial that keep two blocks or
# more on an SM
_SMS = 132
_DX_FILTER_BYTES = 36 * 1024
_DF_SLAB_BYTES = 36 * 1024


def conv_bwd_layout(c: int, mult: int, f_bins: int, owners: int,
                    tiles: int) -> tuple[int, int, int, int]:
    """How ``csrc/dense_conv_bwd.cu`` lays out its blocks for ``C``
    channels (a lane holds a channel and its r terms; 32-lane slots),
    ``F`` bins, ``owners`` = B * ceil(N / 128) dx owners per slice of
    channels and ``tiles`` = B * n_t query tiles: (dx_slots, dx_chunks,
    df_slots, df_split).

    A dx owner holds ``dx_slots`` slots (at most 4: its accumulators are
    registers, 16 rows x slots a thread; fewer where its (F, 32 slots, r)
    filter slice outgrows ``_DX_FILTER_BYTES``), the most that still give
    an owner to each SM, and the row takes ``dx_chunks`` owners, as even as
    the slots allow. A dfilt block holds ``df_slots`` slots (1, 2 or 4;
    fewer where its (F, 32 slots, r) partial outgrows ``_DF_SLAB_BYTES``),
    so the map is read once per 128 channels for dfilt at F <= 33, and
    takes 128 / ``df_split`` rows of a tile: the fewest parts that give
    four blocks an SM (more than one part on the small decoder clouds).
    Measured on the card (PERF.md): 8 slots a dfilt block, and fewer
    than one dx owner an SM, were slower."""
    def fits(slots, limit):
        return f_bins * 32 * slots * mult * 4 <= limit

    top = next((s for s in (4, 3, 2) if fits(s, _DX_FILTER_BYTES)), 1)
    for max_slots in range(top, 0, -1):
        dx_chunks = -(-c // (32 * max_slots))
        per_chunk = -(-c // dx_chunks)
        dx_slots = -(-per_chunk // 32)
        if dx_chunks * owners >= _SMS:
            break
    df_slots = next(s for s in (1, 2, 4) if 32 * s >= min(c, 128))
    while df_slots > 1 and not fits(df_slots, _DF_SLAB_BYTES):
        df_slots //= 2
    df_chunks = -(-c // (32 * df_slots))
    df_split = next((s for s in (1, 2, 4)
                     if df_chunks * tiles * s >= 4 * _SMS), 8)
    return dx_slots, dx_chunks, df_slots, df_split


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy where its data is not 16-byte aligned (the
    kernel reads it with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dense_conv_bwd_kernel(packed, s_blk, inputs, filt_b, inv, dout,
                          layout=None):
    """The conv backward through ``csrc/dense_conv_bwd.cu``, three
    launches: the dfilt partials of each query tile (a block per tile, or
    per part of its rows, walks the rows' windows once), their sum over
    tiles in tile order, and dx, whose rows have one owner per 128-row
    block of ``inputs`` that walks the query tiles whose window covers
    it, in tile order, with the next tile's map slice in flight.
    ``layout``: the blocks' layout (:func:`conv_bwd_layout`'s by default;
    the tests pass others to reach every compiled variant: each covers
    every channel and sums in its own fixed order). Returns (dx,
    dfilt_b) as the plain version."""
    _build.check(packed, "packed", torch.int8, 4)
    _build.check(inputs, "inputs", (torch.float32, torch.bfloat16), 3)
    filt_b = filt_b.contiguous()   # an expanded (ungrouped) filter
    _build.check(filt_b, "filt_b", torch.float32, 4)
    _build.check(inv, "inv", torch.float32, 2)
    _build.check(dout, "dout", inputs.dtype, 3)
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    f_bins, mult = filt_b.shape[1], filt_b.shape[3]
    if not 1 <= c <= _MAX_CONV_BWD_C or mult not in (1, 2):
        raise ValueError(
            f"dense conv backward kernel takes C <= {_MAX_CONV_BWD_C} and a "
            f"depth multiplier of 1 or 2, got C={c}, r={mult}"
        )
    if filt_b.shape != (batch, f_bins, c, mult) or f_bins > 127:
        raise ValueError(f"bad per-cloud filter shape {tuple(filt_b.shape)}")
    if inv.shape != (batch, n_t * TILE):
        raise ValueError(f"bad inverse-count shape {tuple(inv.shape)}")
    if dout.shape != (batch, n_t * TILE, c * mult):
        raise ValueError(f"bad output-gradient shape {tuple(dout.shape)}")
    if s_blk.shape != (batch, n_t):
        raise ValueError(f"bad window-start shape {tuple(s_blk.shape)}")
    sb = s_blk.to(torch.int64).contiguous()   # a graph's, as it is
    _build.check(sb, "s_blk", torch.int64, 2)
    packed, inv = _aligned(packed), _aligned(inv)
    dx_slots, dx_chunks, df_slots, df_split = layout or conv_bwd_layout(
        c, mult, f_bins, batch * -(-num_in // TILE), batch * n_t)
    dx = torch.empty_like(inputs)
    dfilt = torch.empty((batch, f_bins, c, mult), dtype=torch.float32,
                        device=inputs.device)
    part = torch.empty((batch, n_t * df_split, f_bins, c * mult),
                       dtype=torch.float32, device=inputs.device)
    CONV_BWD_KERNEL.launch(
        _build.ptr(packed), _build.ptr(sb), _build.ptr(inputs),
        _build.ptr(filt_b), _build.ptr(inv), _build.ptr(dout),
        _build.ptr(dx), _build.ptr(dfilt), _build.ptr(part),
        batch, n_t, num_in, c, f_bins, w, mult,
        int(inputs.dtype == torch.bfloat16), dx_slots, dx_chunks, df_slots,
        df_split, _build.stream(inputs),
    )
    return dx, dfilt


class _DenseConv(torch.autograd.Function):
    """The conv with its hand-written backward. ``packed``, ``s_blk`` and
    ``inv`` get no gradient: the graph and the counts are constants (as in
    the JAX VJP, ``ops/dense.py:1069-1076``)."""

    @staticmethod
    def forward(ctx, inputs, filt_b, packed, s_blk, inv, use_kernels):
        args = (packed, s_blk, inputs, filt_b, inv)
        _build.record("dense_conv", *args)
        ctx.save_for_backward(*args)
        ctx.use_kernels = use_kernels
        if _build.use_kernel(inputs, use_kernels):
            return dense_conv_kernel(*args)
        return dense_conv_plain(*args)

    @staticmethod
    def backward(ctx, dout):
        packed, s_blk, inputs, filt_b, inv = ctx.saved_tensors
        args = (packed, s_blk, inputs, filt_b, inv, dout.contiguous())
        _build.record("dense_conv_bwd", *args)
        if _build.use_kernel(inputs, ctx.use_kernels):
            dx, dfilt = dense_conv_bwd_kernel(*args)
        else:
            dx, dfilt = dense_conv_bwd_plain(*args)
        return dx, dfilt, None, None, None, None


def conv_operands(
    inputs: torch.Tensor, filt: torch.Tensor, dnbh: DenseNeighborhood
) -> tuple[torch.Tensor, torch.Tensor]:
    """The conv kernel's per-cloud filter and inverse counts.

    Returns (filt_b (B, F, C, r) f32: the filter rounded to the compute
    dtype, its bin rows in the map's (sort-grouped) order for each cloud;
    inv (B, M_pad) f32: 1 / max(count, 1), the reference's neighbor
    mean). The grouped rows are picked by a one-hot product, so autograd
    un-permutes and sums the per-cloud filter gradient with a matmul (no
    scatter-add: reproducible on the card); an ungrouped filter is one
    filter expanded over the clouds (a view, no copy)."""
    batch = inputs.shape[0]
    m_pad = dnbh.s_blk.shape[1] * TILE
    cnt_p = F.pad(dnbh.count, (0, m_pad - dnbh.num_query))
    inv = 1.0 / torch.clamp_min(cnt_p, 1).float()
    filt_c = filt.to(inputs.dtype).float()
    if dnbh.grouped:
        f_bins = filt.shape[0]
        perm = torch.tensor(_grouped_perm(f_bins), device=filt.device)
        pick = F.one_hot(perm[dnbh.axis.long()], f_bins).float()  # (B,F,F)
        filt_b = torch.einsum("bgf,fcr->bgcr", pick, filt_c).contiguous()
    else:
        # one filter for every cloud: the conv reads it in place
        filt_b = filt_c.contiguous().expand((batch,) + filt_c.shape)
    return filt_b, inv.contiguous()


def dense_depthwise_conv3d(
    inputs: torch.Tensor,
    filt: torch.Tensor,
    dnbh: DenseNeighborhood,
    pointwise: torch.Tensor | None = None,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Depthwise spherical conv from dense maps (no edge lists).

    out[b,m,c*r+j] = sum_w [packed==f+1] in[win(w), c] filt[f,c,j] / cnt
    (ref tf_conv3d_gpu.cu:20-27 incl. the neighbor mean), summed in f32
    and cast once to the input dtype.

    Args:
      inputs: (B, N, C) float features (f32 or bf16).
      filt:   (F, C, r) filter (bin_size, in_channels, multiplier).
      dnbh:   dense neighborhood over the same cloud.
      pointwise: optional (C*r, O) channel-major pointwise kernel; the
        separable conv's 1x1 GEMM, f32-accumulated in the input dtype.

    Returns:
      (B, M, C*r), or (B, M, O) with ``pointwise``, in the input dtype.
    """
    dtype = inputs.dtype
    filt_b, inv = conv_operands(inputs, filt, dnbh)
    out = _DenseConv.apply(inputs.contiguous(), filt_b, dnbh.packed,
                           dnbh.s_blk, inv, use_kernels)
    if pointwise is not None:
        out = einsum_f32("bmk,ko->bmo", out, pointwise.to(dtype)).to(dtype)
    return out[:, :dnbh.num_query]


def _pool_result(out, arg, index):
    """A pool's return: ``out`` alone, or ``(out, arg)``, ``(out, index)``
    or ``(out, arg, index)`` for the outputs asked for."""
    extra = tuple(t for t in (arg, index) if t is not None)
    return (out, *extra) if extra else out


def _padded_counts(counts, batch, m_pad):
    """(B, M_pad) rank bounds from (B, M <= M_pad) counts, 0 past M; None
    (a bin map): every nonzero entry, the int8 map's largest rank."""
    if counts is None:
        return torch.full((batch, m_pad), 127, dtype=torch.int32)
    return F.pad(counts, (0, m_pad - counts.shape[1]))


def rank_pool_plain(packed, s_blk, counts, inputs, with_arg=False,
                    with_index=False):
    """Plain PyTorch masked max over the entries whose rank lies in
    1..count (``counts`` (B, M <= M_pad), 0 past M; None: every nonzero
    entry, as for a bin map), chunked over tiles; rows with none give 0.
    With ``with_arg`` also the first window column attaining the max
    (-0 and +0 tie; -1 for a row with none), with ``with_index`` the
    op-level ``max_index`` ``min(s_blk * 128 + column, N - 1)`` (column
    0 for a row with none), both (B, M_pad, C) int32: returns as
    :func:`_pool_result`."""
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    rows, valid, b_of_g = _window_rows(packed, s_blk, num_in)
    pk = packed.reshape(batch * n_t, TILE, w)
    cnt = _padded_counts(counts, batch, n_t * TILE).to(packed.device)
    cnt = cnt.reshape(batch * n_t, TILE, 1)
    out = torch.empty((batch * n_t, TILE, c), dtype=inputs.dtype,
                      device=inputs.device)
    track = with_arg or with_index
    arg = torch.empty((batch * n_t, TILE, c), dtype=torch.int32,
                      device=inputs.device) if track else None
    step = max(1, _PLAIN_BUDGET // (TILE * w * c))
    for g0 in range(0, batch * n_t, step):
        sl = slice(g0, g0 + step)
        xw = inputs[b_of_g[sl, None], rows[sl]].float()         # (g, W, C)
        sel = (pk[sl] >= 1) & (pk[sl] <= cnt[sl]) & valid[sl, None, :]
        cand = torch.where(sel[..., None], xw[:, None], -float("inf"))
        best = cand.amax(dim=2) + 0.0                           # -0 -> +0
        some = sel.any(dim=-1)[..., None]
        out[sl] = torch.where(some, best, 0.0).to(inputs.dtype)
        if track:
            hit = sel[..., None] & (cand == best[:, :, None, :])
            first = hit.to(torch.uint8).argmax(dim=2)      # first maximum
            arg[sl] = torch.where(some, first, -1).to(torch.int32)
    out = out.reshape(batch, n_t * TILE, c)
    index = None
    if track:
        arg = arg.reshape(batch, n_t * TILE, c)
        if with_index:
            start = s_blk.long().repeat_interleave(TILE, dim=1) * TILE
            index = (start[..., None] + arg.clamp(min=0)).clamp(
                max=num_in - 1).to(torch.int32)
    return _pool_result(out, arg if with_arg else None, index)


def _pool_vector_bytes(row_bytes: int, inputs: torch.Tensor) -> int:
    """The widest vector (16, 8, 4 or 2 bytes, at least an element) that
    divides a feature row and the features' address: K4's loads."""
    return next(v for v in (16, 8, 4, 2)
                if row_bytes % v == 0 and inputs.data_ptr() % v == 0
                and v >= inputs.element_size())


def rank_pool_kernel(packed, s_blk, counts, inputs, with_arg=False,
                     with_index=False):
    """The pool through ``csrc/rank_pool.cu``: one warp per query row
    walks the row's map once, 512 columns a step, into a list of the
    selected columns, then folds every channel of the row from that
    list, feature rows read as vectors, several hits in flight. The
    graph's int64 ``s_blk`` and int32 ``counts`` (a (B, M) view of the
    query's (B, M_pad) counts included) are read in place; ``counts``
    None selects every nonzero entry. Returns as the plain version."""
    _build.check(packed, "packed", torch.int8, 4)
    _build.check(inputs, "inputs", (torch.float32, torch.bfloat16), 3)
    batch, n_t, _, w = packed.shape
    _, num_in, c = inputs.shape
    if not 1 <= c <= _MAX_POOL_C:
        raise ValueError(f"rank pool kernel takes C <= {_MAX_POOL_C}, got {c}")
    if w % 16 or w > _MAX_POOL_WINDOW:
        raise ValueError(f"rank pool kernel takes windows of whole 16-byte "
                         f"words up to {_MAX_POOL_WINDOW}, got {w}")
    if s_blk.shape != (batch, n_t):
        raise ValueError(f"bad window-start shape {tuple(s_blk.shape)}")
    s_blk = s_blk.to(torch.int64).contiguous()   # a graph's, as it is
    if counts is not None:
        if (counts.dim() != 2 or counts.shape[0] != batch
                or counts.shape[1] > n_t * TILE
                or counts.dtype != torch.int32
                or counts.device != inputs.device):
            raise ValueError(
                f"counts must be (B, M <= M_pad) int32 on {inputs.device}, "
                f"got {tuple(counts.shape)} {counts.dtype} on "
                f"{counts.device}")
        if counts.stride(1) != 1:
            counts = counts.contiguous()
    packed = _aligned(packed)
    shape = (batch, n_t * TILE, c)
    dev = inputs.device
    out = torch.empty(shape, dtype=inputs.dtype, device=dev)
    arg = torch.empty(shape, dtype=torch.int32, device=dev) \
        if with_arg else None
    index = torch.empty(shape, dtype=torch.int32, device=dev) \
        if with_index else None
    row_bytes = c * inputs.element_size()
    POOL_KERNEL.launch(
        _build.ptr(packed), _build.ptr(s_blk),
        None if counts is None else _build.ptr(counts),
        0 if counts is None else counts.stride(0),
        0 if counts is None else counts.shape[1],
        _build.ptr(inputs), _build.ptr(out),
        None if arg is None else _build.ptr(arg),
        None if index is None else _build.ptr(index),
        batch, n_t, num_in, c, w, int(inputs.dtype == torch.bfloat16),
        _pool_vector_bytes(row_bytes, inputs), _build.stream(inputs),
    )
    return _pool_result(out, arg, index)


def rank_pool_bwd_plain(s_blk, arg, dout, num_in, window):
    """Plain PyTorch backward of the rank pool: each row's output gradient
    goes to its first attaining window column (``arg``), i.e. the cloud
    row ``s_blk * 128 + arg``; rows with ``arg == -1`` give nothing.
    Summed in f32, rounded once: (B, num_in, C) in ``dout``'s dtype.
    ``window`` is the kernel's (it skips tiles whose window misses a
    block); every column is in the window here by construction."""
    del window
    batch, m_pad, c = arg.shape
    rows = s_blk.long().repeat_interleave(TILE, dim=1)[..., None] * TILE
    live = arg >= 0
    flat = torch.arange(batch, device=arg.device)[:, None, None] * num_in
    flat = torch.where(live, flat + rows + arg, 0)
    dx = torch.zeros((batch * num_in, c), dtype=torch.float32,
                     device=dout.device)
    dx.scatter_add_(0, flat.reshape(-1, c),
                    torch.where(live, dout.float(), 0.0).reshape(-1, c))
    return dx.reshape(batch, num_in, c).to(dout.dtype)


def rank_pool_bwd_kernel(s_blk, arg, dout, num_in, window):
    """The pool backward through ``csrc/rank_pool_bwd.cu``, one launch
    with no float atomics: a thread block per (8 consecutive 128-row
    blocks of the input, cloud, 32-channel slice) stages each tile whose
    window meets those blocks once, and one warp per input block adds, in
    tile and row order, the output gradients whose first attaining column
    lands in its block. Returns as the plain version."""
    _build.check(arg, "arg", torch.int32, 3)
    _build.check(dout, "dout", (torch.float32, torch.bfloat16), 3)
    batch, m_pad, c = arg.shape
    n_t = s_blk.shape[1]
    if not 1 <= c <= _MAX_POOL_C:
        raise ValueError(
            f"rank pool backward kernel takes C <= {_MAX_POOL_C}, got {c}")
    if dout.shape != arg.shape or m_pad != n_t * TILE or window % TILE:
        raise ValueError(
            f"bad pool backward shapes: arg {tuple(arg.shape)}, dout "
            f"{tuple(dout.shape)}, {n_t} tiles, window {window}")
    sb = s_blk.to(torch.int64).contiguous()  # as the graph holds it
    dx = torch.empty((batch, num_in, c), dtype=dout.dtype,
                     device=dout.device)
    POOL_BWD_KERNEL.launch(
        _build.ptr(sb), _build.ptr(arg), _build.ptr(dout), _build.ptr(dx),
        batch, n_t, num_in, c, window, int(dout.dtype == torch.bfloat16),
        _build.stream(dout),
    )
    return dx


def _rank_pool(packed, s_blk, counts, inputs, with_arg, with_index,
               use_kernels):
    """The pool through the kernel (CUDA tensors) or its plain version:
    (out, arg or None, index or None)."""
    args = (packed, s_blk, counts, inputs)
    kw = {k: True for k, v in (("with_arg", with_arg),
                               ("with_index", with_index)) if v}
    _build.record("rank_pool", *args, **kw)
    if _build.use_kernel(inputs, use_kernels):
        res = rank_pool_kernel(*args, **kw)
    else:
        res = rank_pool_plain(*args, **kw)
    res = res if isinstance(res, tuple) else (res,)
    arg = res[1] if with_arg else None
    return res[0], arg, res[-1] if with_index else None


class _RankPool(torch.autograd.Function):
    """The rank pool with its hand-written backward: the forward also
    returns the first attaining column (not differentiable) and, with
    ``with_index``, the op-level ``max_index`` from the same launch; the
    backward routes each output gradient to that column (ties to the
    smallest rank, as the JAX VJP)."""

    @staticmethod
    def forward(ctx, inputs, packed, s_blk, counts, with_index,
                use_kernels):
        out, arg, index = _rank_pool(packed, s_blk, counts, inputs, True,
                                     with_index, use_kernels)
        extra = (arg,) if index is None else (arg, index)
        ctx.mark_non_differentiable(*extra)
        ctx.save_for_backward(s_blk, arg)
        ctx.num_in = inputs.shape[1]
        ctx.window = packed.shape[-1]
        ctx.use_kernels = use_kernels
        return (out, *extra)

    @staticmethod
    def backward(ctx, dout, *_):
        s_blk, arg = ctx.saved_tensors
        args = (s_blk, arg, dout.contiguous(), ctx.num_in, ctx.window)
        _build.record("rank_pool_bwd", *args)
        if _build.use_kernel(dout, ctx.use_kernels):
            dx = rank_pool_bwd_kernel(*args)
        else:
            dx = rank_pool_bwd_plain(*args)
        return dx, None, None, None, None, None


def pool_counts(dnbh: DenseNeighborhood) -> torch.Tensor | None:
    """The pool's rank bounds: the graph's (B, M) int32 neighbor counts
    for a rank map (read in place), None for a bin-valued map (every
    nonzero entry is selected)."""
    return dnbh.count if dnbh.k_max > 0 else None


def dense_max_pool3d(
    inputs: torch.Tensor,
    dnbh: DenseNeighborhood,
    with_index: bool = False,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Max pooling from dense maps: (out (B, M, C) in the input dtype,
    max_index (B, M, C) int32 or None). Rows with no selected neighbor
    give 0 (the reference's untouched output). Differentiable in
    ``inputs``: all of an output's gradient goes to its first attaining
    neighbor, -0 and +0 tying (the JAX VJP's routing).

    ``with_index=True`` also returns each output's input-point id (the
    reference ``MaxPool3d`` op's ``max_index``, as the JAX op gives it):
    ``min(s_blk * 128 + column, N - 1)`` for the first attaining window
    column; a row with no selected neighbor takes column 0. The kernel
    writes it in the pool's launch. Models pass False and get the
    values-only launch at inference."""
    args = (dnbh.packed, dnbh.s_blk, pool_counts(dnbh), inputs.contiguous())
    if torch.is_grad_enabled() and inputs.requires_grad:
        res = _RankPool.apply(args[3], *args[:3], with_index, use_kernels)
        out, index = res[0], (res[2] if with_index else None)
    else:
        out, _, index = _rank_pool(*args, False, with_index, use_kernels)
    num_q = dnbh.num_query
    return out[:, :num_q], None if index is None else index[:, :num_q]


def window_mean_bwd(packed, s_blk, dout, num_in, weights=None,
                    use_kernels=None):
    """Backward of the masked window sum of the unpools and the avg pool:
    (B, num_in, C) f32 from ``dout`` (B, M_pad, C) f32.

    Window row w of tile t is cloud row ``s_blk[t] * 128 + w``; its
    gradient is ``sum over the tile's query rows r of lhs[t, r, w] *
    dout[t, r]`` (lhs the 0/1 mask of the selected entries, or the
    weighted unpool's ``weights`` (B, nT, TILE, W), 0 off the selection),
    and every cloud row sums the gradients of the window rows that are it.
    K9's form (b) (``windowed.window_sum_bwd_kernel``; its plain version
    on a CPU tensor or with ``use_kernels=False``) forms each window
    row's gradient from the map and ``dout`` as it sums them: every cloud
    row has one owner and its terms one fixed order (reproducible), and
    the work grows with the windows' selected entries, not with the cloud
    times the tiles. Autograd of the window gather would scatter-add them
    instead: float atomics on a CUDA device, or a sorting path under
    ``torch.use_deterministic_algorithms``."""
    lhs = packed if weights is None else weights
    if _build.use_kernel(dout, use_kernels):
        return windowed.window_sum_bwd_kernel(lhs, s_blk, dout, num_in)
    return windowed.window_sum_bwd_plain(lhs, s_blk, dout, num_in)


class _WindowSum(torch.autograd.Function):
    """The masked window sum ``sum_w lhs[t, w] x[win(w)]`` per query row, in
    f32 (B, M_pad, C): lhs the 0/1 mask of the selected entries or the
    given ``weights``. :func:`window_mean_bwd` is its backward; the map
    and the weights are constants."""

    @staticmethod
    def forward(ctx, inputs, packed, s_blk, weights, use_kernels):
        batch, n_t, _, w = packed.shape
        num_in = inputs.shape[1]
        rows, valid, b_of_g = _window_rows(packed, s_blk, num_in)
        fw = inputs[b_of_g[:, None], rows].masked_fill(~valid[..., None], 0)
        lhs = (packed > 0) if weights is None else weights
        ctx.save_for_backward(packed, s_blk, weights)
        ctx.num_in, ctx.dtype = num_in, inputs.dtype
        ctx.use_kernels = use_kernels
        return einsum_f32("gtw,gwc->gtc", lhs.reshape(batch * n_t, TILE, w),
                          fw).reshape(batch, n_t * TILE, -1)

    @staticmethod
    def backward(ctx, dout):
        packed, s_blk, weights = ctx.saved_tensors
        args = (packed, s_blk, dout.contiguous(), ctx.num_in)
        kw = {} if weights is None else {"weights": weights}
        _build.record("mean_interpolate_bwd", *args, **kw)
        dx = window_mean_bwd(*args, **kw, use_kernels=ctx.use_kernels)
        return dx.to(ctx.dtype), None, None, None, None


def _masked_mean(inputs, dnbh, use_kernels, name):
    """Each query row's mean over its selected window entries: the sum in
    f32, rounded to the input dtype, then scaled by ``1 / max(count, 1)``
    computed in the input dtype (the JAX op's rounding points,
    ``ops/dense.py:2398-2436``)."""
    _build.record(name, inputs, dnbh)
    n_t = dnbh.packed.shape[1]
    dtype = inputs.dtype
    out = _WindowSum.apply(inputs, dnbh.packed, dnbh.s_blk, None,
                           use_kernels)
    cnt_p = F.pad(dnbh.count, (0, n_t * TILE - dnbh.num_query))
    inv = 1.0 / torch.clamp_min(cnt_p, 1).to(dtype)
    return (out.to(dtype) * inv[..., None])[:, :dnbh.num_query]


def dense_mean_interpolate(
    inputs: torch.Tensor, dnbh: DenseNeighborhood,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Mean unpooling: each fine point's masked mean over its selected
    coarse neighbors (ref tf_unpool3d_gpu.cu:5-22): one batched matmul of
    the 0/1 maps with the gathered feature windows (:func:`_masked_mean`).
    Differentiable in ``inputs`` through :func:`window_mean_bwd`, which
    runs K9 (``use_kernels`` as the other wrappers take it); the
    forward is plain PyTorch, as the JAX package leaves this op to XLA,
    with no Pallas kernel.

    Returns (B, M, C) in the input dtype."""
    return _masked_mean(inputs, dnbh, use_kernels, "mean_interpolate")


def dense_avg_pool3d(
    inputs: torch.Tensor, dnbh: DenseNeighborhood,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Average pooling from dense maps: the masked mean over the selected
    neighbors (ref tf_pool3d_gpu.cu:53-70), the same function as
    :func:`dense_mean_interpolate` (the JAX package aliases the two).
    Rows with no selected neighbor give 0. Returns (B, M, C) in the input
    dtype."""
    return _masked_mean(inputs, dnbh, use_kernels, "avg_pool")


WEIGHT_EPS = 1e-7   # ref utils/sph3gcn_util.py:317-321


def interpolation_weights(dnbh: DenseNeighborhood) -> torch.Tensor:
    """The weighted unpool's f32 weights (B, nT, TILE, W): per selected
    entry ``(dist + 1e-7) / (sum of the row's selected dist + 1e-7)``,
    0 elsewhere: proportional to the sqrt-space distance, the reference's
    quirk (ref utils/sph3gcn_util.py:317-321)."""
    if dnbh.dist is None:
        raise ValueError(
            "the weighted unpool needs distance maps: build the graph with "
            "need_dist=True")
    sel = dnbh.packed > 0
    dist = torch.where(sel, dnbh.dist, 0.0)
    sum_dist = dist.sum(dim=-1, keepdim=True)
    return torch.where(sel, (dist + WEIGHT_EPS) / (sum_dist + WEIGHT_EPS),
                       0.0)


def dense_weighted_interpolate(
    inputs: torch.Tensor, dnbh: DenseNeighborhood,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Distance-weighted unpooling (ref utils/sph3gcn_util.py:300-325): per
    fine point the sum of its selected coarse neighbors' features times
    :func:`interpolation_weights`, the weights rounded to the input dtype
    before the product, summed in f32 and rounded once (the JAX op's
    rounding points, ``ops/dense.py:2416-2418,2443-2460``). Needs a graph
    built with ``need_dist``. Differentiable in ``inputs`` through
    :func:`window_mean_bwd` with the weights in place of the 0/1 mask (it
    runs K9); the forward is plain PyTorch, as the JAX package
    leaves this op to XLA.

    Returns (B, M, C) in the input dtype."""
    weights = interpolation_weights(dnbh).to(inputs.dtype)
    _build.record("weighted_interpolate", inputs, dnbh)
    out = _WindowSum.apply(inputs, dnbh.packed, dnbh.s_blk, weights,
                           use_kernels)
    return out.to(inputs.dtype)[:, :dnbh.num_query]


def dense_ids_prob(dnbh: DenseNeighborhood) -> torch.Tensor:
    """IDS sampling probability (B, M) f32: per query the sum of its
    selected sqrt-space distances over its count (ref
    utils/sph3gcn_util.py:37-39). Needs a graph built with ``need_dist``."""
    if dnbh.dist is None:
        raise ValueError("dense_ids_prob needs distance maps: build the "
                         "graph with need_dist=True")
    batch = dnbh.packed.shape[0]
    dist_sum = torch.where(dnbh.packed > 0, dnbh.dist, 0.0).sum(dim=-1)
    dist_sum = dist_sum.reshape(batch, -1)[:, :dnbh.num_query]
    return dist_sum / torch.clamp_min(dnbh.count, 1).float()
