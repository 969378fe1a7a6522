"""Grid-average voxel downsampling and nearest-neighbour label transfer
(counterpart of ``sph3d_gcn_tpu/data/prep/voxelize.py``, equal output for
equal input).

Python port of the MATLAB ``pcdownsample(...,'gridAverage', voxel)`` calls
(ref preprocesing/s3dis_prepare_data.m:35-37,
preprocesing/scannet_prepare_data.m:100-112). Points falling in the same
voxel are averaged (positions and attributes, summed in float64 in
``np.unique``'s order of the voxels); labels are transferred by majority
vote within the voxel or by nearest-neighbour back-projection, as the
ScanNet prep does.
"""

from __future__ import annotations

import numpy as np


def grid_average_downsample(
    xyz: np.ndarray, attributes: np.ndarray | None = None, voxel: float = 0.03
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """Average points (and attributes) within each occupied voxel.

    Args:
      xyz: (N, 3) float coordinates.
      attributes: optional (N, A) per-point attributes to average (e.g. rgb).
      voxel: edge length in the same unit as xyz.

    Returns:
      (voxel_xyz (M, 3) f32, voxel_attributes (M, A) f32 or None,
       voxel_id (N,) int: the output row each input point maps to).
    """
    xyz = np.asarray(xyz, np.float64)
    mins = xyz.min(axis=0)
    cells = np.floor((xyz - mins) / voxel).astype(np.int64)
    dims = cells.max(axis=0) + 1
    flat = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    uniq, inverse = np.unique(flat, return_inverse=True)
    num = len(uniq)
    counts = np.bincount(inverse, minlength=num).astype(np.float64)

    out_xyz = np.zeros((num, 3))
    for d in range(3):
        out_xyz[:, d] = np.bincount(inverse, xyz[:, d], num) / counts

    out_attr = None
    if attributes is not None:
        attributes = np.asarray(attributes, np.float64)
        out_attr = np.zeros((num, attributes.shape[1]))
        for d in range(attributes.shape[1]):
            out_attr[:, d] = (
                np.bincount(inverse, attributes[:, d], num) / counts
            )
    return out_xyz.astype(np.float32), (
        None if out_attr is None else out_attr.astype(np.float32)
    ), inverse


def majority_label(labels: np.ndarray, inverse: np.ndarray, num: int
                   ) -> np.ndarray:
    """Majority-vote label per voxel given the point->voxel map (ties go
    to the lowest label)."""
    labels = np.asarray(labels, np.int64)
    num_cls = labels.max() + 1 if labels.size else 1
    votes = np.zeros((num, num_cls), np.int64)
    np.add.at(votes, (inverse, labels), 1)
    return votes.argmax(axis=1).astype(np.int32)


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
