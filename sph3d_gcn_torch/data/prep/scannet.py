"""ScanNet's label maps (counterpart of the 21 <-> 40-class maps of
``sph3d_gcn_tpu/data/prep/scannet.py``, ref
preprocesing/scannet_prepare_data.m and post-merging/scannet_merge.m).
The NYU-40 label set is reduced to 20 benchmark classes and 0 for every
other one: 21 network classes. The scene preparation is not ported yet.
"""

from __future__ import annotations

import numpy as np

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
