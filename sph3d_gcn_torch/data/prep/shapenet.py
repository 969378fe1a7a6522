"""ShapeNet part-segmentation preparation and records (counterpart of
``sph3d_gcn_tpu/data/prep/shapenet.py``, equal output for equal input).

Ports `preprocesing/shapenet_prepare_data.m` (unit-sphere normalize,
singular-point removal, global part ids) and `io/make_tfrecord_shapenet.py`
(xzy->xyz swap, one record a shape). A record holds ``xyz_raw`` (N, 3)
f32, ``part_label`` (the category's parts) and ``seg_label`` (the 50
global parts) as int32, both stored 0-based, and ``cls_label`` (ref
io/make_tfrecord_shapenet.py:105-118). scipy's ``cKDTree`` is imported
at use, so the package imports without scipy.
"""

from __future__ import annotations

import numpy as np

from sph3d_gcn_torch.data.tfrecord import TFRecordWriter, read_examples


def remove_singular_points(
    xyz: np.ndarray, label: np.ndarray, radius: float = 0.3
) -> tuple[np.ndarray, np.ndarray, int]:
    """Drop points whose radius-neighborhood contains no other point of the
    same part label (ref shapenet_prepare_data.m:44-59). Runs only when some
    part has <= 10 points, like the reference (:45-46).

    Returns (xyz, label, num_removed).
    """
    counts = np.bincount(label)
    small = (counts > 0) & (counts <= 10)
    if not small.any():
        return xyz, label, 0
    from scipy.spatial import cKDTree

    neighbor_lists = cKDTree(xyz).query_ball_point(xyz, radius)
    same = np.array([int(np.sum(label[nbrs] == label[i]))
                     for i, nbrs in enumerate(neighbor_lists)])
    keep = same > 1  # the point itself always matches -> singular == 1
    return xyz[keep], label[keep], int((~keep).sum())


def normalize_shape(xyz: np.ndarray) -> np.ndarray:
    """Center + unit-sphere scale (ref shapenet_prepare_data.m:34-37)."""
    xyz = xyz - xyz.mean(axis=0)
    scale = np.sqrt(np.sum(xyz**2, axis=1))
    return (xyz / scale.max()).astype(np.float32)


def make_shapenet_records(
    shapes: list[tuple[np.ndarray, np.ndarray, int]],
    part_offset: dict[int, int],
    store_path: str,
) -> None:
    """Write one record per shape: {xyz_raw, part_label (per-category ids),
    seg_label (global part ids), cls_label}
    (ref io/make_tfrecord_shapenet.py:105-118).

    Args:
      shapes: (xyz (N,3) already normalized, per-category part labels
        1-based like the reference data, category id) per shape.
      part_offset: category id -> global part-id offset
        (the reference accumulates ``totalParts`` across categories,
        ref shapenet_prepare_data.m:62-66).
      store_path: output tfrecord path.
    """
    with TFRecordWriter(store_path) as w:
        for xyz, part_label, cls_id in shapes:
            xyz = xyz[:, [0, 2, 1]]  # xzy -> xyz (ref :62)
            seg_label = part_label + part_offset[cls_id]
            # stored 0-based (ref make_tfrecord_shapenet.py:63-64)
            w.write_example({
                "xyz_raw": xyz.astype(np.float32).tobytes(),
                "part_label": (part_label - 1).astype(np.int32).tobytes(),
                "seg_label": (seg_label - 1).astype(np.int32).tobytes(),
                "cls_label": np.int64(cls_id),
            })


def load_shapenet_records(files: list[str]) -> list[dict]:
    """Read back {xyz, part_label, seg_label, cls_label} per shape."""
    out = []
    for path in files:
        for ex in read_examples(path):
            out.append({
                "xyz": np.frombuffer(ex["xyz_raw"][0],
                                     np.float32).reshape(-1, 3),
                "part_label": np.frombuffer(ex["part_label"][0], np.int32),
                "seg_label": np.frombuffer(ex["seg_label"][0], np.int32),
                "cls_label": int(ex["cls_label"][0]),
            })
    return out
