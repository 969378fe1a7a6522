"""ScanNet preparation and label maps (counterpart of
``sph3d_gcn_tpu/data/prep/scannet.py``, ref
preprocesing/scannet_prepare_data.m and post-merging/scannet_merge.m).
The NYU-40 label set is reduced to 20 benchmark classes and 0 for every
other one: 21 network classes. ``prepare_scene`` downsamples a scene on
a 3 cm grid and transfers its labels by nearest neighbour (ref
scannet_prepare_data.m:75-112); block cutting is ``prep.blocks``.
"""

from __future__ import annotations

import numpy as np

from sph3d_gcn_torch.data.prep.voxelize import (
    grid_average_downsample,
    knn_transfer,
)

# ref scannet_prepare_data.m:11 (1-based NYU-40 ids kept for the benchmark)
SUBSET_LABEL_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39],
    np.int32,
)

ALL_CLASS_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower curtain", "box", "whiteboard", "person", "nightstand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
]


def nyu40_to_benchmark21(label: np.ndarray) -> np.ndarray:
    """NYU-40 1-based labels -> 0 (ignored) and the benchmark classes
    1..20 (ref scannet_prepare_data.m:80-88)."""
    label = np.asarray(label, np.int64)
    out = np.zeros_like(label, dtype=np.int32)
    for k, nyu_id in enumerate(SUBSET_LABEL_IDS, start=1):
        out[label == nyu_id] = k
    return out


def benchmark21_to_nyu40(label21: np.ndarray) -> np.ndarray:
    """Network classes 0..20 -> NYU-40 ids for a benchmark submission, 0
    to 0 (ref scannet_merge.m:8,53-55)."""
    table = np.concatenate([[0], SUBSET_LABEL_IDS]).astype(np.int32)
    return table[np.asarray(label21, np.int64)]


def prepare_scene(
    xyz: np.ndarray,
    rgb: np.ndarray,
    nyu_label: np.ndarray | None,
    voxel: float = 0.03,
):
    """Downsample a scene and transfer labels like the MATLAB prep
    (ref scannet_prepare_data.m:75-112).

    For train scenes: drop points with labels outside [1, 40], remap to
    the 21-class set, 3cm grid-average downsample, knn label transfer from
    the full cloud. For test scenes (label None): downsample only.

    Returns (voxel_xyz, voxel_rgb, voxel_label_or_None).
    """
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    if nyu_label is not None:
        nyu_label = np.asarray(nyu_label)
        keep = (nyu_label >= 1) & (nyu_label <= 40)
        xyz, rgb, nyu_label = xyz[keep], rgb[keep], nyu_label[keep]
        label21 = nyu40_to_benchmark21(nyu_label)
    v_xyz, v_rgb, _ = grid_average_downsample(xyz, rgb, voxel)
    if nyu_label is None:
        return v_xyz, v_rgb, None
    return v_xyz, v_rgb, knn_transfer(xyz, label21, v_xyz)
