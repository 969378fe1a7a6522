"""S3DIS preparation, the whole reference pipeline in one command
(counterpart of the JAX package's ``scripts/prepare_s3dis.py``)::

    python -m sph3d_gcn_torch.cli.prepare_s3dis \\
        --data_path Stanford3dDataset_v1.2_Aligned_Version --store_folder DIR

Replaces `preprocesing/s3dis_prepare_data.m` (3 cm grid-average
voxelization), `io/make_tfrecord_s3dis.py` (room normalization,
overlapping block cutting with context padding and inner masks, a record
file a room, the ``log_block.txt`` manifest, the six fold lists) and
`io/make_tfrecord_s3dis_nosplit.py` (whole-room ground truth for the
scene re-merge, written as ``scenes/<Area>_<room>.npz``: the file
``cli.evaluate_scene_seg --scene_dir`` reads).

Expects the standard layout
``<data_path>/Area_N/<room>/Annotations/<class>_k.txt`` (x y z r g b
rows). Host numpy only: it runs no model.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

# ref io/make_tfrecord_s3dis.py:41-53
S3DIS_CLASSES = {
    "ceiling": 0, "floor": 1, "wall": 2, "beam": 3, "column": 4,
    "window": 5, "door": 6, "table": 7, "chair": 8, "sofa": 9,
    "bookcase": 10, "board": 11, "clutter": 12,
}
# ref io/make_tfrecord_s3dis.py:56-66
S3DIS_SCENES = {
    "office": 0, "conferenceroom": 1, "hallway": 2, "auditorium": 3,
    "openspace": 4, "lobby": 5, "lounge": 6, "pantry": 7, "copyroom": 8,
    "storage": 9, "wc": 10,
}
AREAS = [f"Area_{i}" for i in range(1, 7)]


def load_room(room_path: str):
    """Annotations/*.txt -> (xyz, rgb, label); the class from the file
    name (ref make_tfrecord_s3dis.py:85-103; unknown classes -> clutter)."""
    xyz, rgb, label = [], [], []
    for path in sorted(glob.glob(os.path.join(room_path, "Annotations",
                                              "*.txt"))):
        data = np.loadtxt(path, dtype=np.float32)
        if data.ndim == 1:
            data = data[None]
        if data.shape[1] != 6:
            raise ValueError(f"{path}: expected xyz+rgb")
        key = os.path.basename(path).split("_")[0]
        cls = S3DIS_CLASSES.get(key, S3DIS_CLASSES["clutter"])
        xyz.append(data[:, 0:3])
        rgb.append(data[:, 3:6])
        label.append(np.full(len(data), cls, np.int32))
    return np.concatenate(xyz), np.concatenate(rgb), np.concatenate(label)


def process_room(area, room_path, store_folder, scene_folder, voxel,
                 block_size, interval, context, min_points, log_f) -> str:
    """One room: voxelize, normalize, write its scene npz and its block
    records (a line of ``log_f`` a block). Returns the record file."""
    from sph3d_gcn_torch.data.prep.blocks import cut_blocks, normalize_room
    from sph3d_gcn_torch.data.prep.voxelize import (
        grid_average_downsample,
        knn_transfer,
    )
    from sph3d_gcn_torch.data.tfrecord import TFRecordWriter

    room = os.path.basename(room_path)
    full_xyz, full_rgb, full_label = load_room(room_path)

    # 3cm voxelization (ref s3dis_prepare_data.m:35-37) + label transfer
    v_xyz, v_rgb, _ = grid_average_downsample(full_xyz, full_rgb, voxel)
    v_label = knn_transfer(full_xyz, full_label, v_xyz)

    # rgb -> [-1, 1]; room bottom-center normalize + rel coords
    # (ref make_tfrecord_s3dis.py:113-132)
    rgb_n = (2 * v_rgb / 255.0 - 1).astype(np.float32)
    xyz_n, rel = normalize_room(v_xyz)

    # whole-room ground truth for the merge (replaces
    # make_tfrecord_s3dis_nosplit.py and the data/s3dis_full .mat files)
    scene_name = f"{area}_{room}"
    np.savez(
        os.path.join(scene_folder, scene_name + ".npz"),
        xyz=xyz_n, label=v_label,
        full_xyz=(full_xyz - full_xyz.min(0) + xyz_n.min(0)).astype(
            np.float32),
        full_label=full_label,
    )

    blocks = cut_blocks(xyz_n, block_size, interval, context, min_points)
    out = os.path.join(store_folder, scene_name + ".tfrecord")
    scene_key = room.split("_")[0].lower()
    suffix = room.split("_")[-1]
    with TFRecordWriter(out) as w:
        for blk in blocks:
            sel = blk.index
            log_f.write(f"{area}, {room}, {int(blk.inner.sum())}, "
                        f"{len(sel)}\n")
            w.write_example({
                "rgb_raw": rgb_n[sel].tobytes(),
                "seg_label": v_label[sel].astype(np.int32).tobytes(),
                "inner_label": blk.inner.astype(np.int32).tobytes(),
                "index_label": sel.astype(np.int32).tobytes(),
                "scene_label": np.int64(S3DIS_SCENES.get(scene_key, 0)),
                "scene_idx": np.int64(int(suffix) if suffix.isdigit()
                                      else 0),
                "rel_xyz_raw": rel[sel].tobytes(),
                "xyz_raw": xyz_n[sel].tobytes(),
            })
    log_f.flush()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--store_folder", required=True)
    parser.add_argument("--voxel", type=float, default=0.03)
    parser.add_argument("--block_size", type=float, default=1.5)
    parser.add_argument("--interval", type=float, default=0.75)
    parser.add_argument("--context", type=float, default=0.3)
    parser.add_argument("--min_points", type=int, default=10000)
    return parser.parse_args(argv)


def main(argv=None) -> list[str]:
    """Returns the record files written, a room each."""
    args = parse_args(argv)
    os.makedirs(args.store_folder, exist_ok=True)
    scene_folder = os.path.join(args.store_folder, "scenes")
    os.makedirs(scene_folder, exist_ok=True)

    written = []
    with open(os.path.join(args.store_folder, "log_block.txt"), "a") as log_f:
        for area in AREAS:
            for room_path in sorted(
                    glob.glob(os.path.join(args.data_path, area, "*"))):
                if not os.path.isdir(room_path):
                    continue
                print(f"processing {area}/{os.path.basename(room_path)}")
                written.append(process_room(
                    area, room_path, args.store_folder, scene_folder,
                    args.voxel, args.block_size, args.interval,
                    args.context, args.min_points, log_f))

    # 6-fold train/test lists (ref make_tfrecord_s3dis.py:268-279)
    for i, area in enumerate(AREAS):
        with open(os.path.join(args.store_folder,
                               f"test_files_fold{i + 1}.txt"), "w") as test_f, \
                open(os.path.join(args.store_folder,
                                  f"train_files_fold{i + 1}.txt"),
                     "w") as train_f:
            for path in written:
                (test_f if area in os.path.basename(path)
                 else train_f).write(path + "\n")
    return written


if __name__ == "__main__":
    main()
