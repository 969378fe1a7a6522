"""RueMonge2014 facade preparation (counterpart of the JAX package's
``scripts/prepare_ruemonge2014.py``; replaces
`preprocesing/ruemonge2014_prepare_data.m` and
`io/make_tfrecord_ruemonge2014.py`)::

    python -m sph3d_gcn_torch.cli.prepare_ruemonge2014 --data_path DIR \\
        --store_folder OUT

Inputs: ``pcl.txt`` (x y z nx ny nz r g b rows), ``pcl_gt_train.ply`` /
``pcl_gt_test.ply`` (label colours, black where unlabelled) and
``pcl_split.txt`` (a facade split id a point). Outputs: a record file a
facade block with xyz, normal and rgb features, its
``scenes/<phase>_facade_<i>.npz`` ground truth, and ``train_files.txt`` /
``test_files.txt``. Host numpy only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--store_folder", required=True)
    parser.add_argument("--min_points", type=int, default=2000)
    return parser.parse_args(argv)


def main(argv=None) -> dict[str, list[str]]:
    """Returns the record files written, by phase."""
    args = parse_args(argv)
    from sph3d_gcn_torch.data.prep.ply import read_ply_xyz_rgb
    from sph3d_gcn_torch.data.prep.ruemonge import (
        rgb2label,
        split_facade_blocks,
        swap_axes_z_up,
    )
    from sph3d_gcn_torch.data.tfrecord import TFRecordWriter

    data = np.loadtxt(os.path.join(args.data_path, "pcl.txt"),
                      dtype=np.float32)
    xyz = swap_axes_z_up(data[:, 0:3])
    normal = swap_axes_z_up(data[:, 3:6])
    rgb = data[:, 6:9].astype(np.float32)
    split_labels = np.loadtxt(os.path.join(args.data_path, "pcl_split.txt"),
                              dtype=np.int64)

    os.makedirs(args.store_folder, exist_ok=True)
    scene_dir = os.path.join(args.store_folder, "scenes")
    os.makedirs(scene_dir, exist_ok=True)

    out = {}
    for phase in ("train", "test"):
        _, gt_rgb, _ = read_ply_xyz_rgb(
            os.path.join(args.data_path, f"pcl_gt_{phase}.ply"))
        labeled = gt_rgb.sum(axis=1) > 0  # unlabeled points are black
        blocks = split_facade_blocks(xyz[labeled], split_labels[labeled],
                                     min_points=args.min_points)
        labeled_idx = np.where(labeled)[0]
        written = []
        for bi, members in enumerate(blocks):
            sel = labeled_idx[members]
            label = rgb2label(gt_rgb[sel].astype(np.uint8))
            scene = f"{phase}_facade_{bi}"
            path = os.path.join(args.store_folder, scene + ".tfrecord")
            with TFRecordWriter(path) as w:
                w.write_example({
                    "xyz_raw": xyz[sel].astype(np.float32).tobytes(),
                    "normal_raw": normal[sel].astype(np.float32).tobytes(),
                    "rgb_raw": (2 * rgb[sel] / 255.0 - 1).astype(
                        np.float32).tobytes(),
                    "seg_label": label.astype(np.int32).tobytes(),
                    "inner_label": np.ones(len(sel), np.int32).tobytes(),
                    "index_label": np.arange(len(sel), dtype=np.int32
                                             ).tobytes(),
                    "scene_label": np.int64(0),
                    "scene_idx": np.int64(bi),
                })
            np.savez(os.path.join(scene_dir, scene + ".npz"),
                     xyz=xyz[sel], label=label)
            written.append(path)
            print(f"{scene}: {len(sel)} points")
        with open(os.path.join(args.store_folder, f"{phase}_files.txt"),
                  "w") as f:
            for p in written:
                f.write(p + "\n")
        out[phase] = written
    return out


if __name__ == "__main__":
    main()
