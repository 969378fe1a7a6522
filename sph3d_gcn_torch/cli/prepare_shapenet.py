"""ShapeNet part-segmentation preparation (counterpart of the JAX
package's ``scripts/prepare_shapenet.py``; replaces
`preprocesing/shapenet_prepare_data.m` and `io/make_tfrecord_shapenet.py`)::

    python -m sph3d_gcn_torch.cli.prepare_shapenet \\
        --data_path shapenetcore_partanno_segmentation_benchmark_v0 \\
        --store_folder OUT

Reads the partanno layout (``synsetoffset2category.txt``,
``<synset>/points/*.pts``, ``<synset>/points_label/*.seg`` and the json
split lists under ``--split_dir``), normalizes each shape to the unit
sphere, removes singular points, assigns global part ids, and writes
``<category>_train0.tfrecord`` / ``_test0`` with their file lists, and
``train_files.txt`` / ``test_files.txt`` over every category (the
one-hot model's). Host numpy only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--store_folder", required=True)
    parser.add_argument("--split_dir", default="train_test_split",
                        help="json split lists inside data_path")
    return parser.parse_args(argv)


def main(argv=None) -> dict[str, tuple[int, int, int]]:
    """Returns {category: (train shapes, test shapes, parts)}."""
    args = parse_args(argv)
    from sph3d_gcn_torch.data.prep.shapenet import (
        make_shapenet_records,
        normalize_shape,
        remove_singular_points,
    )

    cats = []
    with open(os.path.join(args.data_path, "synsetoffset2category.txt")) as f:
        for line in f:
            name, synset = line.split()
            cats.append((name, synset))
    os.makedirs(args.store_folder, exist_ok=True)

    # split membership from the official json lists where present; val
    # joins train
    split_of = {}
    for phase in ("train", "val", "test"):
        path = os.path.join(args.data_path, args.split_dir,
                            f"shuffled_{phase}_file_list.json")
        if os.path.exists(path):
            with open(path) as f:
                for item in json.load(f):
                    split_of[os.path.basename(item)] = (
                        "train" if phase in ("train", "val") else "test")

    part_offset = {}
    total_parts = 0
    summary = {}
    for cls_id, (name, synset) in enumerate(cats):
        part_offset[cls_id] = total_parts
        shapes = {"train": [], "test": []}
        max_part = 0
        for pts_path in sorted(glob.glob(
                os.path.join(args.data_path, synset, "points", "*.pts"))):
            stem = os.path.splitext(os.path.basename(pts_path))[0]
            seg_path = os.path.join(args.data_path, synset, "points_label",
                                    stem + ".seg")
            xyz = np.loadtxt(pts_path, dtype=np.float32)
            label = np.loadtxt(seg_path, dtype=np.int32)
            xyz = normalize_shape(xyz)
            xyz, label, _ = remove_singular_points(xyz, label)
            max_part = max(max_part, int(label.max()))
            shapes[split_of.get(stem, "train")].append((xyz, label, cls_id))
        total_parts += max_part
        for phase in ("train", "test"):
            out = os.path.join(args.store_folder, f"{name}_{phase}0.tfrecord")
            make_shapenet_records(shapes[phase], part_offset, out)
            with open(os.path.join(args.store_folder,
                                   f"{name}_{phase}_files.txt"), "w") as f:
                f.write(out + "\n")
        summary[name] = (len(shapes["train"]), len(shapes["test"]), max_part)
        print(f"{name}: {len(shapes['train'])} train / "
              f"{len(shapes['test'])} test shapes, {max_part} parts")

    # combined lists for the one-hot variant
    for phase in ("train", "test"):
        with open(os.path.join(args.store_folder, f"{phase}_files.txt"),
                  "w") as f:
            for name, _ in cats:
                f.write(os.path.join(args.store_folder,
                                     f"{name}_{phase}0.tfrecord") + "\n")
    return summary


if __name__ == "__main__":
    main()
