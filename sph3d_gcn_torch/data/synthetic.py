"""Synthetic ModelNet-like clouds for smoke runs and benchmarks."""

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
