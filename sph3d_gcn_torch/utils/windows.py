"""Window calibration: measure per-level slab requirements on data
(counterpart of ``sph3d_gcn_tpu/utils/windows.py``).

The dense engine is exact iff every graph's in-range candidate slab fits
its configured row window. This module replays the model's level pyramid
(spatial sort, FPS, radius schedule) on sample clouds and records, for
every graph the model builds — encoder intra, pooling, decoder intra,
decoder inter with the +0.05 radius growth (ref tf_nnquery_gpu.cu:30-60)
— the window width ``build_dense_graph`` needs for its coverage certificate
to hold, with the tile and slab arithmetic of
``ops.dense.build_dense_graph``. :func:`derive_config_windows` turns the
measurements into ``SPH3DConfig.windows`` / ``dec_windows`` /
``dec_margin`` / ``growth_steps``; ``cli.measure_windows`` is the
command line.

The sort and FPS (K1 on a CUDA device, its plain version on the CPU) and
the nearest-neighbor distances run on ``device``; the slab arithmetic is
NumPy on the host. The results equal the JAX package's on the same
clouds.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from sph3d_gcn_torch.ops.locality import permute_points, spatial_sort
from sph3d_gcn_torch.ops.sample import farthest_point_sample

TILE = 128
_BOUNDARY_EPS = 1e-6
_QUERY_CHUNK = 1024


def _round_up(x: int, m: int) -> int:
    return int(-(-int(x) // m) * m)


@dataclasses.dataclass
class LevelRequirement:
    """Worst-case measured slab widths (rows) for one pyramid level."""

    enc: int = 0        # intra graph at the level cloud
    pool: int = 0       # sampled points querying the level cloud
    dec: int = 0        # decoder intra graph at the sampled cloud
    dec_inter: int = 0  # finer cloud querying the sampled cloud (+growth)
    growth: int = 0     # max growth steps any inter row needed


def slab_requirement(
    db_key: np.ndarray, q_key: np.ndarray, radius, growth_block: bool = False
) -> int:
    """Required window rows for one graph on one cloud: per 128-query
    tile, from the tile's clamped start block to the last db row with key
    <= tile_max + radius (``build_dense_graph``'s slab arithmetic).

    Args:
      db_key: (N,) sorted db coordinates along the sort axis.
      q_key: (M,) query coordinates along the same axis.
      radius: scalar or per-tile (nT,) search radius (grown radii differ
        per tile).
      growth_block: ``build_dense_graph`` starts growth windows one block
        early.

    Returns:
      The required W in rows (not rounded to 128).
    """
    m = len(q_key)
    m_pad = _round_up(m, TILE)
    qk = np.full(m_pad, np.nan, np.float64)
    qk[:m] = q_key
    qk = qk.reshape(-1, TILE)
    tile_min = np.nanmin(qk, axis=1)
    tile_max = np.nanmax(qk, axis=1)
    real = ~np.isnan(tile_min)
    radius = np.broadcast_to(np.asarray(radius, np.float64), tile_min.shape)
    lo = tile_min - radius
    hi = tile_max + radius
    s_row = np.searchsorted(db_key, lo, side="left")
    e_row = np.searchsorted(db_key, hi, side="right")
    s_start = s_row // TILE - (1 if growth_block else 0)
    need = e_row - np.maximum(s_start, 0) * TILE
    need = np.where(real, need, 0)
    return int(need.max(initial=0))


def nearest_distances(db: np.ndarray, q: np.ndarray,
                      device: torch.device | str = "cpu") -> np.ndarray:
    """(M,) f32 distance from each query to its nearest db point, on
    ``device``: the squared distance as ``(dx*dx + dy*dy) + dz*dz`` in
    f32, its minimum, then one correctly rounded square root on the host
    (the square root is monotone, so this is the minimum of the rounded
    distances, bit for bit)."""
    dbt = torch.as_tensor(np.ascontiguousarray(db[:, :3], np.float32),
                          device=device)
    qt = torch.as_tensor(np.ascontiguousarray(q[:, :3], np.float32),
                         device=device)
    out = []
    for i0 in range(0, len(q), _QUERY_CHUNK):
        delta = qt[i0:i0 + _QUERY_CHUNK, None, :] - dbt[None, :, :]
        dx, dy, dz = delta.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz
        out.append(d2.amin(dim=1))
    d2_min = torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)
    return np.sqrt(d2_min)


def growth_steps_needed(
    db: np.ndarray, q: np.ndarray, radius: float, max_steps: int = 64,
    device: torch.device | str = "cpu",
) -> np.ndarray:
    """Per query, the first growth step with >= 1 strict-< in-range
    neighbor (the reference's +0.05 rescan schedule,
    ref tf_nnquery_gpu.cu:30-60). Returns (M,) int32; ``max_steps`` marks
    rows that never find one."""
    d_min = nearest_distances(db, q, device)
    steps = np.full(len(q), max_steps, np.int32)
    r = np.float32(radius)
    for g in range(max_steps):
        hit = (d_min < r) & (np.abs(d_min - r) > _BOUNDARY_EPS)
        steps = np.where(hit & (steps == max_steps), g, steps)
        r = np.float32(r + np.float32(0.05))
    return steps


def _pyramids(cfg, clouds: np.ndarray, device, normalize
              ) -> list[np.ndarray]:
    """Per level, the (B, N_level, 3) clouds of the model's pyramid: the
    spatially sorted (and then normalized) input, then each level's FPS
    sample in ascending index order (all clouds at once: FPS treats each
    on its own)."""
    pts = torch.as_tensor(np.ascontiguousarray(clouds[..., :3], np.float32),
                          device=device)
    perm, _ = spatial_sort(pts, cfg.radius[0])
    pts = permute_points(pts, perm)
    if normalize is not None:
        pts = normalize(pts)
    levels = [pts]
    for s in cfg.num_sample[: len(cfg.radius)]:
        idx = torch.sort(farthest_point_sample(s, pts), dim=1).values
        pts = permute_points(pts, idx)
        levels.append(pts)
    return [lv.cpu().numpy() for lv in levels]


def measure_requirements(cfg, clouds: np.ndarray,
                         device: torch.device | str = "cuda",
                         normalize: Callable[[torch.Tensor], torch.Tensor]
                         | None = None) -> list[LevelRequirement]:
    """Replay cfg's pyramid on (B, N, 3+) clouds and collect the worst
    slabs. IDS/random configs are measured with FPS: their samples are a
    subset of the same cloud at the same radii, so their slab widths are
    statistically the same. ``device``: where the sort, FPS and nearest
    distances run (the card unless the caller asks for the CPU).
    ``normalize``: the model's input normalization, applied after the
    sort as the model applies it (ModelNet's ``normalize_unit_sphere``:
    its model picks the sort axis on the raw cloud, and the axis a
    normalized cloud picks can differ); None measures the clouds as
    given, as JAX's function does."""
    num_levels = len(cfg.radius)
    reqs = [LevelRequirement() for _ in range(num_levels)]
    pyramid = _pyramids(cfg, clouds, device, normalize)
    for b in range(len(clouds)):
        for level in range(num_levels):
            fine = pyramid[level][b]
            coarse = pyramid[level + 1][b]
            r = cfg.radius[level]
            key_f = fine[:, _sort_axis(fine)].astype(np.float64)
            key_c = coarse[:, _sort_axis(coarse)].astype(np.float64)
            req = reqs[level]
            req.enc = max(req.enc, slab_requirement(key_f, key_f, r))
            req.pool = max(req.pool, slab_requirement(key_f, key_c, r))
            req.dec = max(req.dec, slab_requirement(key_c, key_c, r))
            # decoder inter: fine points query the coarse cloud, with the
            # build_dense_graph's per-tile grown radius re-certification
            g = growth_steps_needed(coarse, fine, r, device=device)
            req.growth = max(req.growth, int(g.max(initial=0)))
            m_pad = _round_up(len(fine), TILE)
            g_pad = np.zeros(m_pad, np.int32)
            g_pad[: len(fine)] = np.minimum(g, 63)
            g_tile = g_pad.reshape(-1, TILE).max(axis=1)
            r_eff = r + 0.05 * g_tile
            req.dec_inter = max(
                req.dec_inter,
                slab_requirement(key_c, key_f, r_eff, growth_block=True),
            )
    return reqs


def _sort_axis(pts: np.ndarray) -> int:
    """The axis the cloud is sorted along (first non-decreasing axis)."""
    for a in range(3):
        if np.all(np.diff(pts[:, a]) >= 0):
            return a
    raise ValueError("cloud is not axis-sorted")


def derive_config_windows(
    cfg, reqs: list[LevelRequirement], margin: float = 0.10
) -> tuple[tuple[int, ...], tuple[int, ...], int, int]:
    """The smallest window tables covering every measured requirement
    with ``margin`` headroom: (windows, dec_windows, dec_margin,
    growth_steps) for ``SPH3DConfig``. The encoder window also covers
    the pooling graph through the config's additive pool formula;
    decoder windows get their own table."""
    num_levels = len(cfg.radius)
    windows: list[int] = []
    dec_windows: list[int] = []
    dec_margin = 0
    probe = dataclasses.replace(
        cfg, windows=(TILE,) * num_levels, spatial_sort=True
    )
    for level, r in enumerate(reqs):
        n_level = cfg.num_input if level == 0 else cfg.num_sample[level - 1]
        cap = _round_up(n_level, TILE)
        s_cap = _round_up(cfg.num_sample[level], TILE)
        pool_extra = probe.pool_window(level) - TILE
        enc_need = r.enc * (1 + margin)
        pool_need = r.pool * (1 + margin) - pool_extra
        w = _round_up(max(enc_need, pool_need, TILE), TILE)
        windows.append(min(w, cap))
        dw = _round_up(max(r.dec * (1 + margin), TILE), TILE)
        dec_windows.append(min(dw, s_cap))
        dec_margin = max(
            dec_margin, r.dec_inter * (1 + margin) - dec_windows[-1]
        )
    dec_margin = max(_round_up(max(dec_margin, 0), TILE), TILE)
    growth = max((r.growth for r in reqs), default=0)
    return tuple(windows), tuple(dec_windows), dec_margin, growth + 2
