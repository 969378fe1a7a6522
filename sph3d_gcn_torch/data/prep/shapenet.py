"""ShapeNet part-segmentation records (counterpart of the reader in
``sph3d_gcn_tpu/data/prep/shapenet.py``; the record writer and the
singular-point removal are not ported yet). A record holds one shape:
``xyz_raw`` (N, 3) f32, ``part_label`` (the category's parts) and
``seg_label`` (the 50 global parts) as int32, both stored 0-based, and
``cls_label`` (ref io/make_tfrecord_shapenet.py:105-118)."""

from __future__ import annotations

import numpy as np

from sph3d_gcn_torch.data.tfrecord import read_examples


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
