"""Nearest-neighbour label transfer (counterpart of ``knn_transfer`` in
``sph3d_gcn_tpu/data/prep/voxelize.py``; the grid-average downsampling
there is not ported yet)."""

from __future__ import annotations

import numpy as np


def knn_transfer(
    src_xyz: np.ndarray, src_values: np.ndarray, dst_xyz: np.ndarray
) -> np.ndarray:
    """Each destination point takes the value of its nearest source point
    (the MATLAB ``knnsearch`` pattern, ref
    preprocesing/scannet_prepare_data.m:100-112,
    post-merging/s3dis_merge.m:73-76). scipy's ``cKDTree`` answers, as in
    the JAX package, so ties resolve the same way; scipy is imported here,
    so the package imports without it."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(src_xyz))
    _, idx = tree.query(np.asarray(dst_xyz), k=1)
    return np.asarray(src_values)[idx]
