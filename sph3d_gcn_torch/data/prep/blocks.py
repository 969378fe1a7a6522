"""Scene -> overlapping-block cutting with context padding and inner masks
(counterpart of ``sph3d_gcn_tpu/data/prep/blocks.py``, equal output for
equal input).

The reference's block cutter (ref io/make_tfrecord_s3dis.py:140-242,
reused for ScanNet):

- overlapping grid of ``block_size`` blocks on an ``interval`` stride over
  the xy extent (z unbounded), with end blocks snapped to the far edge;
- blocks whose *inner* point count is below ``min_points`` try to merge into
  one of eight 2x-sized neighbor rectangles, in a fixed order; if none is
  big enough the block is dropped;
- the stored block adds a ``context`` ring around the inner rectangle; the
  ``inner`` mask marks the true block points (only these are evaluated /
  contribute to the loss);
- ``index`` maps block points back to scene points for the scene re-merge.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Block:
    index: np.ndarray  # (P,) int32 scene-point indices of the stored points
    inner: np.ndarray  # (P,) int32 1 = true block point, 0 = context


def _grid_starts(lo: float, hi: float, block_size: float, interval: float):
    """Block start coordinates (ref make_tfrecord_s3dis.py:150-166)."""
    starts = np.arange(lo, hi - block_size, interval)
    if not starts.size:
        starts = np.append(starts, lo)
    if starts[-1] < hi - block_size:
        starts = np.append(starts, hi - block_size)
    return starts


def _in_rect(xyz: np.ndarray, min_x, max_x, min_y, max_y) -> np.ndarray:
    return ((xyz[:, 0] >= min_x) & (xyz[:, 0] <= max_x)
            & (xyz[:, 1] >= min_y) & (xyz[:, 1] <= max_y))


def cut_blocks(
    xyz: np.ndarray,
    block_size: float = 1.5,
    interval: float | None = None,
    context: float = 0.3,
    min_points: int = 10000,
) -> list[Block]:
    """Cut a scene into overlapping context-padded blocks.

    Args:
      xyz: (N, 3) scene coordinates (already room-normalized).
      block_size: xy block edge (reference uses 1.5 m, ref :249).
      interval: stride; defaults to block_size/2 (ref :250). Values >=
        block_size disable overlap (ref :145-148).
      context: context-padding ring (ref default 0.3, ref :39).
      min_points: inner-point threshold below which a block merges into a
        neighbor or is dropped (ref :38,178-200).

    Returns:
      list of Block(index, inner).
    """
    xyz = np.asarray(xyz)
    if interval is None:
        interval = block_size / 2
    if interval >= block_size:
        interval = block_size

    mins = xyz.min(axis=0)
    maxs = xyz.max(axis=0)
    x_starts = _grid_starts(mins[0], maxs[0], block_size, interval)
    y_starts = _grid_starts(mins[1], maxs[1], block_size, interval)

    blocks: list[Block] = []
    for x in x_starts:
        for y in y_starts:
            rect = (x, x + block_size, y, y + block_size)
            if _in_rect(xyz, *rect).sum() < min_points:
                # the eight 2x-sized neighbor rectangles in reference
                # order (ref make_tfrecord_s3dis.py:179-199)
                candidates = [
                    (x - block_size, x + block_size, y, y + block_size),
                    (x, x + 2 * block_size, y, y + block_size),
                    (x, x + block_size, y - block_size, y + block_size),
                    (x, x + block_size, y, y + 2 * block_size),
                    (x - block_size, x + block_size, y - block_size,
                     y + block_size),
                    (x - block_size, x + block_size, y, y + 2 * block_size),
                    (x, x + 2 * block_size, y - block_size, y + block_size),
                    (x, x + 2 * block_size, y, y + 2 * block_size),
                ]
                rect = next((c for c in candidates
                             if _in_rect(xyz, *c).sum() >= min_points), None)
                if rect is None:
                    continue
            min_x, max_x, min_y, max_y = rect
            stored = _in_rect(xyz, min_x - context, max_x + context,
                              min_y - context, max_y + context)
            inner_mask = _in_rect(xyz[stored], *rect)
            blocks.append(Block(index=np.where(stored)[0].astype(np.int32),
                                inner=inner_mask.astype(np.int32)))
    return blocks


def normalize_room(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Room normalization: align to bottom-center, compute rel_xyz in
    [-1, 1] (ref make_tfrecord_s3dis.py:113-132).

    Returns (centered_xyz, rel_xyz)."""
    xyz = np.asarray(xyz, np.float32)
    xyz_min = xyz.min(axis=0, keepdims=True)
    xyz_max = xyz.max(axis=0, keepdims=True)
    center = (xyz_min + xyz_max) / 2
    center[0, -1] = xyz_min[0, -1]  # z -> floor
    centered = xyz - center
    extent = xyz_max - xyz_min
    rel = np.zeros_like(xyz)
    rel[:, 0] = 2 * centered[:, 0] / extent[0, 0]
    rel[:, 1] = 2 * centered[:, 1] / extent[0, 1]
    rel[:, 2] = 2 * centered[:, 2] / extent[0, 2] - 1.0
    return centered, rel
