"""ScanNet preparation (counterpart of the JAX package's
``scripts/prepare_scannet.py``; replaces `preprocesing/scannet_prepare_data.m`,
`scannet_plyread.m` and `io/make_tfrecord_scannet.py`)::

    python -m sph3d_gcn_torch.cli.prepare_scannet --data_path DIR \\
        --store_folder OUT

Reads ``<data_path>/train/*.ply`` and ``<data_path>/test/*.ply`` (ascii
or binary little-endian; x, y, z, red, green, blue and, for training
scenes, an NYU-40 ``label``). Per scene: the NYU-40 -> 21-class remap
(train), 3 cm voxelization with nearest-neighbour label transfer, room
normalization, overlapping block cutting; a record file a scene, its
``scenes/<scene>.npz`` ground truth, the ``log_block.txt`` manifest and
``train_files.txt`` / ``test_files.txt``. Host numpy only.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def process_scene(path, phase, store_folder, scene_folder, args,
                  log_f) -> str:
    """One scene PLY to its npz and block records. Returns the record
    file."""
    from sph3d_gcn_torch.data.prep.blocks import cut_blocks, normalize_room
    from sph3d_gcn_torch.data.prep.ply import read_ply_xyz_rgb
    from sph3d_gcn_torch.data.prep.scannet import prepare_scene
    from sph3d_gcn_torch.data.tfrecord import TFRecordWriter

    scene = os.path.basename(path).replace(".ply", "")
    xyz, rgb, label = read_ply_xyz_rgb(path)
    if rgb is None:
        rgb = np.zeros_like(xyz)
    is_train = phase == "train" and label is not None
    v_xyz, v_rgb, v_label = prepare_scene(
        xyz, rgb, label if is_train else None, voxel=args.voxel)
    if v_label is None:
        v_label = np.zeros(len(v_xyz), np.int32)

    rgb_n = (2 * v_rgb / 255.0 - 1).astype(np.float32)
    xyz_n, rel = normalize_room(v_xyz)
    np.savez(os.path.join(scene_folder, scene + ".npz"),
             xyz=xyz_n, label=v_label)
    blocks = cut_blocks(xyz_n, args.block_size, args.interval, args.context,
                        args.min_points)
    out = os.path.join(store_folder, scene + ".tfrecord")
    with TFRecordWriter(out) as w:
        for blk in blocks:
            sel = blk.index
            log_f.write(f"{phase}, {scene}, {int(blk.inner.sum())}, "
                        f"{len(sel)}\n")
            w.write_example({
                "rgb_raw": rgb_n[sel].tobytes(),
                "seg_label": v_label[sel].astype(np.int32).tobytes(),
                "inner_label": blk.inner.astype(np.int32).tobytes(),
                "index_label": sel.astype(np.int32).tobytes(),
                "scene_label": np.int64(0),
                "scene_idx": np.int64(0),
                "rel_xyz_raw": rel[sel].tobytes(),
                "xyz_raw": xyz_n[sel].tobytes(),
            })
    log_f.flush()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True,
                        help="directory with train/ and test/ scene PLYs")
    parser.add_argument("--store_folder", required=True)
    parser.add_argument("--voxel", type=float, default=0.03)
    parser.add_argument("--block_size", type=float, default=1.5)
    parser.add_argument("--interval", type=float, default=0.75)
    parser.add_argument("--context", type=float, default=0.3)
    parser.add_argument("--min_points", type=int, default=10000)
    return parser.parse_args(argv)


def main(argv=None) -> dict[str, list[str]]:
    """Returns the record files written, by phase."""
    args = parse_args(argv)
    os.makedirs(args.store_folder, exist_ok=True)
    scene_folder = os.path.join(args.store_folder, "scenes")
    os.makedirs(scene_folder, exist_ok=True)

    out = {}
    with open(os.path.join(args.store_folder, "log_block.txt"), "a") as log_f:
        for phase in ("train", "test"):
            written = []
            for path in sorted(glob.glob(os.path.join(args.data_path, phase,
                                                      "*.ply"))):
                print(f"processing {phase}/{os.path.basename(path)}")
                written.append(process_scene(
                    path, phase, args.store_folder, scene_folder, args,
                    log_f))
            with open(os.path.join(args.store_folder, f"{phase}_files.txt"),
                      "w") as f:
                for p in written:
                    f.write(p + "\n")
            out[phase] = written
    return out


if __name__ == "__main__":
    main()
