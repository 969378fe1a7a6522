"""Seeded raw dataset trees in the published layouts, for the
``cli.prepare_*`` entry points to read in tests and smoke runs (no dataset
is shipped with the repository).

Each writer draws from its ``numpy.random.Generator`` only, and writes
the files the datasets' own distributions hold:

- ModelNet40 ``modelnet40_normal_resampled``: ``<class>/<class>_NNNN.txt``
  rows ``x,y,z,nx,ny,nz`` (ellipsoid surfaces and their normals), the
  class list and the train / test lists;
- S3DIS ``Area_k/<room>/Annotations/<class>_i.txt`` rows ``x y z r g b``:
  a box room's floor, ceiling and walls, a table and clutter;
- ScanNet ``train/`` and ``test/`` scene PLYs: binary little-endian with
  an NYU-40 ``ushort label`` and a face element (train), ascii without
  labels (test);
- ShapeNet parts: ``synsetoffset2category.txt``,
  ``<synset>/points/*.pts``, ``<synset>/points_label/*.seg`` and the json
  split lists;
- RueMonge2014: ``pcl.txt`` rows ``x y z nx ny nz r g b``,
  ``pcl_gt_train.ply`` / ``pcl_gt_test.ply`` (label colours, black where
  a point is not in that split) and ``pcl_split.txt``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

# the label colours of RueMonge2014 (ref rgb2label.m:4-11)
RUEMONGE_COLORS = np.array(
    [[0, 0, 255], [0, 255, 0], [128, 0, 255], [128, 255, 255], [255, 0, 0],
     [255, 128, 0], [255, 255, 0]], np.uint8)


def _savetxt(path: str, rows, fmt: str) -> None:
    """``np.savetxt(path, rows, fmt)`` with ``fmt`` a whole row's format:
    the same text, formatted in one string operation, not row by row."""
    rows = np.asarray(rows)
    rows = rows.reshape(len(rows), -1)
    with open(path, "w") as f:
        f.write((fmt + "\n") * len(rows) % tuple(rows.ravel().tolist()))


def _surface(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(n, 3) points on a random ellipsoid and their unit normals."""
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    axes = rng.uniform(0.3, 1.0, 3)
    normal = v / axes
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    return v * axes, normal


def write_modelnet_tree(root: str, rng, classes=("airplane", "chair",
                                                 "desk"),
                        train_per_class: int = 2, test_per_class: int = 1,
                        points=12000) -> list[str]:
    """The ``modelnet40_normal_resampled`` layout under ``root``: shapes
    of ``points`` points each (an int, or a list cycled over the shapes
    in writing order). Returns the shape names, train then test."""
    sizes = [points] if np.isscalar(points) else list(points)
    os.makedirs(root, exist_ok=True)
    names = {"train": [], "test": []}
    k = 0
    for cls in classes:
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(train_per_class + test_per_class):
            name = f"{cls}_{i + 1:04d}"
            xyz, normal = _surface(rng, sizes[k % len(sizes)])
            k += 1
            _savetxt(os.path.join(root, cls, name + ".txt"),
                     np.concatenate([xyz, normal], axis=1),
                     ",".join(["%.6f"] * 6))
            names["train" if i < train_per_class else "test"].append(name)
    for split, lst in names.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("".join(n + "\n" for n in lst))
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("".join(c + "\n" for c in classes))
    return names["train"] + names["test"]


def _box_faces(rng, lo, hi, n: int, faces: str) -> np.ndarray:
    """``n`` points spread over the named faces ("xXyYzZ": low and high
    face of each axis) of the box [lo, hi]."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    out = []
    for j, face in enumerate(faces):
        m = n // len(faces) + (1 if j < n % len(faces) else 0)
        p = rng.uniform(lo, hi, (m, 3))
        axis = "xyz".index(face.lower())
        p[:, axis] = lo[axis] if face.islower() else hi[axis]
        out.append(p)
    return np.concatenate(out)


def write_s3dis_tree(root: str, rng, rooms=(("Area_1", "office_1"),
                                            ("Area_2", "conferenceRoom_1")),
                     dims=(6.0, 4.0, 3.0), points: int = 300000) -> None:
    """Box rooms of ``dims`` metres with about ``points`` surface points
    each, split into the S3DIS annotation files (floor, ceiling, four
    walls, a table, clutter); colours are integers as the dataset's."""
    w, d, h = dims
    share = {"floor": 0.2, "ceiling": 0.2, "wall": 0.45, "table": 0.05,
             "clutter": 0.1}
    for area, room in rooms:
        ann = os.path.join(root, area, room, "Annotations")
        os.makedirs(ann, exist_ok=True)
        parts = {
            "floor_1": _box_faces(rng, (0, 0, 0), (w, d, h),
                                  int(points * share["floor"]), "z"),
            "ceiling_1": _box_faces(rng, (0, 0, 0), (w, d, h),
                                    int(points * share["ceiling"]), "Z"),
            "wall_1": _box_faces(rng, (0, 0, 0), (w, d, h),
                                 int(points * share["wall"]), "xXyY"),
            "table_1": _box_faces(rng, (1.0, 1.0, 0.0), (2.6, 1.8, 0.75),
                                  int(points * share["table"]), "ZxXyY"),
            "clutter_1": rng.uniform((0, 0, 0), (w, d, 2.0),
                                     (int(points * share["clutter"]), 3)),
        }
        for name, xyz in parts.items():
            rgb = rng.integers(0, 256, (len(xyz), 3))
            _savetxt(os.path.join(ann, name + ".txt"),
                     np.concatenate([xyz, rgb], 1),
                     "%.3f %.3f %.3f %d %d %d")


def _ply_bytes(fmt: str, xyz, rgb, label=None, faces=()) -> bytes:
    props = ["float x", "float y", "float z", "uchar red", "uchar green",
             "uchar blue"] + (["ushort label"] if label is not None else [])
    head = ["ply", f"format {fmt} 1.0", f"element vertex {len(xyz)}"]
    head += [f"property {p}" for p in props]
    if len(faces):
        head += [f"element face {len(faces)}",
                 "property list uchar int vertex_indices"]
    out = ["\n".join(head + ["end_header"]).encode() + b"\n"]
    if fmt == "ascii":
        cols = [xyz.astype(np.float32).tolist(), rgb.tolist()]
        if label is not None:
            cols.append(label[:, None].tolist())
        for row in zip(*cols):
            out.append((" ".join(str(v) for part in row for v in part)
                        + "\n").encode())
        for face in faces:
            out.append((f"{len(face)} " + " ".join(map(str, face))
                        + "\n").encode())
        return b"".join(out)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
              ("green", "u1"), ("blue", "u1")]
    if label is not None:
        fields.append(("label", "<u2"))
    rows = np.zeros(len(xyz), np.dtype(fields))
    for i, axis in enumerate("xyz"):
        rows[axis] = xyz[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        rows[c] = rgb[:, i]
    if label is not None:
        rows["label"] = label
    out.append(rows.tobytes())
    for face in faces:
        out.append(struct.pack(f"<B{len(face)}i", len(face), *face))
    return b"".join(out)


def write_scannet_tree(root: str, rng, train: int = 1, test: int = 1,
                       points: int = 20000,
                       dims=(5.0, 4.0, 2.5)) -> None:
    """``train/scene0NNN_00.ply`` (binary, NYU-40 labels 0-40 with some
    out of range, a face element) and ``test/...`` (ascii, no labels):
    box rooms of ``points`` surface points."""
    for phase, count in (("train", train), ("test", test)):
        os.makedirs(os.path.join(root, phase), exist_ok=True)
        for i in range(count):
            xyz = _box_faces(rng, (0, 0, 0), dims, points, "zZxXyY")
            rgb = rng.integers(0, 256, (points, 3)).astype(np.uint8)
            path = os.path.join(root, phase, f"scene{i:04d}_00.ply")
            if phase == "train":
                label = rng.integers(0, 42, points).astype(np.uint16)
                faces = rng.integers(0, points, (points // 4, 3)).tolist()
                data = _ply_bytes("binary_little_endian", xyz, rgb, label,
                                  faces)
            else:
                data = _ply_bytes("ascii", xyz, rgb)
            with open(path, "wb") as f:
                f.write(data)


def write_shapenet_tree(root: str, rng,
                        cats=(("Airplane", "02691156"),
                              ("Chair", "03001627")),
                        shapes_per_cat: int = 4, points: int = 2600,
                        parts: int = 3) -> None:
    """The partanno layout: ``shapes_per_cat`` shapes a category of
    ``points`` points in ``parts`` parts (1-based, split by height; the
    first shape of the first category with a part of 6 points, two of
    them far out, which the singular-point removal drops), xzy-ordered as
    the dataset stores them; the json lists put each category's last
    shape in test and its second in val."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{name}\t{syn}\n" for name, syn in cats))
    split = {"train": [], "val": [], "test": []}
    for _, syn in cats:
        for d in ("points", "points_label"):
            os.makedirs(os.path.join(root, syn, d), exist_ok=True)
        for i in range(shapes_per_cat):
            stem = f"{syn[-4:]}{i:06x}"
            xyz, _ = _surface(rng, points)
            label = 1 + np.minimum(
                ((xyz[:, 1] - xyz[:, 1].min()) / np.ptp(xyz[:, 1])
                 * parts).astype(np.int64), parts - 1)
            if i == 0 and syn == cats[0][1]:
                label[:6] = parts + 1
                xyz[:2] += 3.0
            _savetxt(os.path.join(root, syn, "points", stem + ".pts"),
                     xyz, "%.5f %.5f %.5f")
            _savetxt(os.path.join(root, syn, "points_label", stem + ".seg"),
                     label, "%d")
            phase = ("test" if i == shapes_per_cat - 1
                     else "val" if i == 1 else "train")
            split[phase].append(f"shape_data/{syn}/{stem}")
    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    for phase, items in split.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{phase}_file_list.json"),
                  "w") as f:
            json.dump(items, f)


def write_ruemonge_tree(root: str, rng, points: int = 30000,
                        facades: int = 4) -> None:
    """A street of ``facades`` facades along x (a split id each, plus a
    small split of 40 points and unlabelled points of split 0), in the
    dataset's y-up axes: ``pcl.txt``, ``pcl_split.txt`` and the label
    colours of the train (even facades) and test (odd) ground truth."""
    os.makedirs(root, exist_ok=True)
    x = rng.uniform(0, 10.0 * facades, points)
    y = rng.uniform(0, 15.0, points)                   # height
    z = rng.normal(0.0, 0.05, points)                  # depth
    xyz = np.stack([x, y, z], 1)
    normal = np.tile([0.0, 0.0, 1.0], (points, 1)) + rng.normal(
        0, 0.01, (points, 3))
    rgb = rng.integers(0, 256, (points, 3))
    split = 1 + np.minimum((x // 10.0).astype(np.int64), facades - 1)
    split[rng.random(points) < 0.05] = 0
    split[:40] = facades + 1
    label = np.minimum((y / 15.0 * 7).astype(np.int64), 6)
    rows = np.concatenate([xyz, normal, rgb], 1)
    _savetxt(os.path.join(root, "pcl.txt"), rows,
             " ".join(["%.4f"] * 6 + ["%d"] * 3))
    _savetxt(os.path.join(root, "pcl_split.txt"), split, "%d")
    colors = RUEMONGE_COLORS[label]
    for phase, parity in (("train", 0), ("test", 1)):
        mine = (split > 0) & (split % 2 == parity)
        gt = np.where(mine[:, None], colors, 0).astype(np.uint8)
        with open(os.path.join(root, f"pcl_gt_{phase}.ply"), "wb") as f:
            f.write(_ply_bytes("binary_little_endian", xyz, gt))
