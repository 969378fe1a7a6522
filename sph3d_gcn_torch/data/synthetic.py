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
