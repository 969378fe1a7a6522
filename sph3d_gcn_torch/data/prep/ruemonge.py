"""RueMonge2014 facade preparation (counterpart of
``sph3d_gcn_tpu/data/prep/ruemonge.py``, equal output for equal input; a
port of `preprocesing/ruemonge2014_prepare_data.m`, `rgb2label.m` and
`label2rgb.m`).

- Axis swap to z-up with height flipped: xyz columns [x, z, y] with
  z -> -z (ref ruemonge2014_prepare_data.m:15-17); normals likewise.
- 7-color <-> label dictionary (ref rgb2label.m:4-11).
- Facade splits with > 2000 labeled points become blocks; smaller splits
  are merged into their nearest neighbor split (ref :44-110). scipy's
  ``cKDTree`` is imported at use.
"""

from __future__ import annotations

import numpy as np

# ref rgb2label.m:4-11 (labels 0..6)
LABEL_COLORS = np.array(
    [
        [0, 0, 255],      # 0 blue: window
        [0, 255, 0],      # 1 green: vegetation
        [128, 0, 255],    # 2 purple: balcony
        [128, 255, 255],  # 3 cyan: sky
        [255, 0, 0],      # 4 red: wall
        [255, 128, 0],    # 5 orange: door
        [255, 255, 0],    # 6 yellow: roof
    ],
    np.uint8,
)


def rgb2label(rgb: np.ndarray) -> np.ndarray:
    """Exact color -> label id (raises on unknown colors, ref rgb2label.m:21)."""
    rgb = np.asarray(rgb, np.uint8)
    match = (rgb[:, None, :] == LABEL_COLORS[None, :, :]).all(axis=2)
    if not match.any(axis=1).all():
        raise ValueError("label color not found!")
    return match.argmax(axis=1).astype(np.int32)


def label2rgb(label: np.ndarray) -> np.ndarray:
    """Label id -> color (ref label2rgb.m)."""
    return LABEL_COLORS[np.asarray(label, np.int64)]


def swap_axes_z_up(xyz: np.ndarray) -> np.ndarray:
    """[x, y, z] file order -> [x, z, -y]: height into +z
    (ref ruemonge2014_prepare_data.m:15-17)."""
    out = xyz[:, [0, 2, 1]].astype(np.float32).copy()
    out[:, 2] = -out[:, 2]
    return out


def split_facade_blocks(
    xyz: np.ndarray,
    split_labels: np.ndarray,
    min_points: int = 2000,
) -> list[np.ndarray]:
    """Group points by facade split id; merge small splits into the split of
    their nearest large-split point (ref ruemonge2014_prepare_data.m:44-110).
    Split id 0 (unlabeled) is dropped (ref :24-25).

    Returns a list of point-index arrays, one per output block.
    """
    split_labels = np.asarray(split_labels)
    ids = np.unique(split_labels)
    ids = ids[ids != 0]
    large = [i for i in ids if (split_labels == i).sum() > min_points]
    small = [i for i in ids if (split_labels == i).sum() <= min_points]

    groups = {i: np.where(split_labels == i)[0] for i in large}
    if small and large:
        from scipy.spatial import cKDTree

        large_idx = np.where(np.isin(split_labels, large))[0]
        tree = cKDTree(xyz[large_idx])
        for i in small:
            members = np.where(split_labels == i)[0]
            _, nearest = tree.query(xyz[members].mean(axis=0, keepdims=True))
            target = split_labels[large_idx[nearest[0]]]
            groups[target] = np.concatenate([groups[target], members])
    return [np.sort(v) for v in groups.values()]
