"""Synthetic ModelNet-like clouds and S3DIS-like scene blocks for smoke
runs and benchmarks."""

from __future__ import annotations

import numpy as np


def surface_clouds(rng: np.random.Generator, batch: int, n: int) -> np.ndarray:
    """(batch, n, 3) f32 points on random ellipsoid surfaces with semi-axes
    in [0.3, 1): ModelNet-like geometry (CAD scans are 2D surfaces inside
    the unit sphere). Draws as the JAX package's benchmark generator
    ``bench.surface_clouds`` does, so one seed gives the same clouds."""
    v = rng.standard_normal((batch, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    axes = rng.uniform(0.3, 1.0, (batch, 1, 3)).astype(np.float32)
    return v * axes


def scene_blocks(rng: np.random.Generator, batch: int, n: int) -> np.ndarray:
    """(batch, n, 9) f32 random 1.5 m scene blocks: xyz (z over 3 m),
    block-relative xyz and rgb in [-1, 1], the S3DIS input columns. Draws
    as the JAX package's benchmark generator ``bench.scene_blocks`` does,
    so one seed gives the same blocks."""
    xyz = rng.uniform(0.0, 1.5, (batch, n, 3)).astype(np.float32)
    xyz[..., 2] *= 2.0
    rel = rng.uniform(-1.0, 1.0, (batch, n, 3)).astype(np.float32)
    rgb = rng.uniform(-1.0, 1.0, (batch, n, 3)).astype(np.float32)
    return np.concatenate([xyz, rel, rgb], axis=-1)


def points_at_sq_distances(queries: np.ndarray, targets: np.ndarray,
                           rng: np.random.Generator) -> np.ndarray:
    """(M, P, 3) f32 points ``w[m, p]`` whose squared distance from
    ``queries[m]``, formed as the dense queries form it (``s = (dx*dx +
    dy*dy) + dz*dz`` in f32 with ``d = w - q``, every product and sum
    rounded), is exactly ``targets[m, p]`` (f32): operands that put points
    on the f32 boundaries of the queries' distance tests.

    The queries must lie on the x axis at x >= 0 (y = z = 0), so that dy
    and dz are exact and fine. x and y take all but 0.1-10% of the target
    on a random direction; z, the rest, is the least f32 whose square
    lifts the sum to the target (bisection over its bit patterns), and a
    draw whose sum steps over the target is drawn again."""
    q = np.asarray(queries, np.float32)
    if (q[:, 1:] != 0).any() or (q[:, 0] < 0).any():
        raise ValueError("queries must lie on the x axis at x >= 0")
    t = np.asarray(targets, np.float32)
    shape = t.shape
    qx = np.broadcast_to(q[:, :1], shape).ravel()
    t = t.ravel()
    out = np.empty((t.size, 3), np.float32)
    todo = np.arange(t.size)
    for _ in range(100):
        if todo.size == 0:
            return out.reshape(*shape, 3)
        tt, qq = t[todo], qx[todo]
        r = np.sqrt(tt.astype(np.float64)) * rng.uniform(0.95, 0.9995,
                                                         todo.size)
        ang = rng.uniform(0.0, 2 * np.pi, todo.size)
        wx = (qq + r * np.cos(ang)).astype(np.float32)
        wy = (r * np.sin(ang)).astype(np.float32)
        dx = wx - qq
        part = dx * dx + wy * wy
        lo = np.zeros(todo.size, np.uint32)
        hi = np.nextafter(np.sqrt(tt), np.float32(np.inf)).view(np.uint32)
        for _ in range(32):            # least wz with part + wz*wz >= tt
            mid = lo + (hi - lo) // 2
            wz = mid.view(np.float32)
            up = part + wz * wz >= tt
            hi = np.where(up, mid, hi)
            lo = np.where(up, lo, mid + 1)
        wz = lo.view(np.float32)
        hit = (part < tt) & (part + wz * wz == tt)
        sign = np.where(rng.random(todo.size) < 0.5, -1, 1).astype(np.float32)
        out[todo[hit]] = np.stack([wx, wy, wz * sign], -1)[hit]
        todo = todo[~hit]
    raise RuntimeError(f"{todo.size} targets not reached")


def ulp_triples(thresholds) -> np.ndarray:
    """T - 1 ulp, T and T + 1 ulp of each f32 threshold T, flat."""
    t = np.float32(thresholds)
    return np.stack([np.nextafter(t, np.float32(0)), t,
                     np.nextafter(t, np.float32(np.inf))], -1).reshape(-1)


def axis_queries(rows: int) -> np.ndarray:
    """(rows, 3) f32 query points on the x axis, 4 apart: a point within
    1 of its row is nearer to it than to any other row."""
    q = np.zeros((rows, 3), np.float32)
    q[:, 0] = 4 * np.arange(rows)
    return q


def boundary_clouds(thresholds, rows: int, rng: np.random.Generator,
                    clouds: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Operands on the boundaries of a dense query's distance tests:
    ``clouds`` databases, each holding for every query row of
    :func:`axis_queries` one point at T - 1 ulp, T and T + 1 ulp in
    squared distance of each threshold T (:func:`points_at_sq_distances`),
    in random order. Returns (databases (clouds, rows * 3T, 3), queries
    (clouds, rows, 3))."""
    q = axis_queries(rows)
    targets = ulp_triples(thresholds)
    dbs = [rng.permutation(points_at_sq_distances(
        q, np.broadcast_to(targets, (rows, targets.size)), rng
    ).reshape(-1, 3)) for _ in range(clouds)]
    return np.stack(dbs), np.stack([q] * clouds)


def growth_boundary_clouds(thresholds, rows: int, rng: np.random.Generator,
                           extra: int = 24) -> tuple:
    """Operands on the boundaries of the growth query's steps, given its
    G + 1 ascending thresholds t_i: query row m of :func:`axis_queries`
    has its nearest point at t_i - 1 ulp, t_i or t_i + 1 ulp in squared
    distance (i = m % (G+1), the variant m // (G+1) % 3) and ``extra``
    more between it and 1.5 t_{i+1}: rows that grow by every step, rows
    alive only at the last radius, rows never alive, rows with many
    neighbors. Returns (database (1, N, 3), queries (1, rows, 3), each
    row's step, each row never alive)."""
    ts = np.float32(thresholds)
    steps = ts.size - 1
    m = np.arange(rows)
    i, v = m % (steps + 1), m // (steps + 1) % 3
    near = ulp_triples(ts).reshape(-1, 3)[i, v]
    upper = 1.5 * ts[np.minimum(i + 1, steps)]
    far = rng.uniform(near[:, None], upper[:, None], (rows, extra))
    q = axis_queries(rows)
    pts = points_at_sq_distances(
        q, np.concatenate([near[:, None], far.astype(np.float32)], 1), rng)
    step = np.where(v == 0, i, i + 1)
    dead = step > steps
    return (rng.permutation(pts.reshape(-1, 3))[None], q[None],
            np.where(dead, 0, step), dead)


def query_operands(db: np.ndarray, q: np.ndarray, window: int | None = None,
                   rng: np.random.Generator | None = None) -> tuple:
    """The dense queries' operands of (B, N, 3) databases and (B, M, 3)
    queries, as numpy arrays: (db_p, q_p, s_blk, u_end, window), padded
    to 128 rows with the sentinels (2e9, 1e9), s_blk and u_end covering
    the whole database or, with ``window``, drawn window starts and u_end
    from -1 to W/128 + 2 (values the queries clamp to [1, W/128])."""
    batch, n, _ = db.shape
    m = q.shape[1]
    n_pad, m_pad = -(-n // 128) * 128, -(-m // 128) * 128
    db_p = np.full((batch, n_pad, 3), 2e9, np.float32)
    db_p[:, :n] = db
    q_p = np.full((batch, m_pad, 3), 1e9, np.float32)
    q_p[:, :m] = q
    n_t = m_pad // 128
    if window is None:
        window = n_pad
        s_blk = np.zeros((batch, n_t), np.int64)
        u_end = np.full((batch, n_t), window // 128, np.int64)
    else:
        s_blk = rng.integers(0, (n_pad - window) // 128 + 1, (batch, n_t))
        u_end = rng.integers(-1, window // 128 + 3, (batch, n_t))
    return db_p, q_p, s_blk, u_end, window
