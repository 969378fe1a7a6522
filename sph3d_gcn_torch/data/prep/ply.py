"""Minimal PLY reader (counterpart of ``sph3d_gcn_tpu/data/prep/ply.py``;
a port of the reference's ``preprocesing/scannet_plyread.m``).

Reads ascii and binary_little_endian files: the vertex element's scalar
properties into arrays, other elements (faces, with list properties)
skipped.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4),
    "double": ("<f8", 8), "float64": ("<f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("<i2", 2), "int16": ("<i2", 2),
    "ushort": ("<u2", 2), "uint16": ("<u2", 2),
    "int": ("<i4", 4), "int32": ("<i4", 4),
    "uint": ("<u4", 4), "uint32": ("<u4", 4),
}


def _read_header(f, path: str) -> tuple[str | None, list]:
    """(format, [(element, count, [property spec, ...]), ...])."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path} is not a PLY file")
    fmt = None
    elements: list = []
    while True:
        line = f.readline().decode("ascii").strip()
        if line.startswith("comment"):
            continue
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            _, name, count = line.split()
            elements.append((name, int(count), []))
        elif line.startswith("property"):
            parts = line.split()
            if parts[1] == "list":
                elements[-1][2].append((parts[-1], "list", parts[2],
                                        parts[3]))
            else:
                elements[-1][2].append((parts[-1], parts[1]))
        elif line == "end_header":
            return fmt, elements


def _skip_element(f, fmt: str, count: int, props: list) -> None:
    """Skip a non-vertex element: ascii rows are lines, binary rows are
    parsed property by property (lists carry their own length)."""
    if fmt == "ascii":
        for _ in range(count):
            f.readline()
        return
    for _ in range(count):
        for p in props:
            if p[1] == "list":
                (n,) = np.frombuffer(f.read(_TYPES[p[2]][1]), _TYPES[p[2]][0])
                f.read(int(n) * _TYPES[p[3]][1])
            else:
                f.read(_TYPES[p[1]][1])


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the vertex properties of a PLY file into {name: (N,) array}
    (float64 from an ascii file, the declared type from a binary one)."""
    with open(path, "rb") as f:
        fmt, elements = _read_header(f, path)
        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if name != "vertex":
                _skip_element(f, fmt, count, props)
            elif fmt == "ascii":
                rows = np.loadtxt([f.readline() for _ in range(count)],
                                  dtype=np.float64)
                if rows.ndim == 1:
                    rows = rows[None]
                for i, p in enumerate(props):
                    out[p[0]] = rows[:, i]
            elif fmt == "binary_little_endian":
                dtype = np.dtype([(p[0], _TYPES[p[1]][0]) for p in props])
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype)
                for p in props:
                    out[p[0]] = np.array(data[p[0]])
            else:
                raise ValueError(f"unsupported PLY format {fmt}")
        return out


def read_ply_xyz_rgb(path: str):
    """(xyz (N,3) f32, rgb (N,3) f32 or None, label (N,) int32 or None)."""
    props = read_ply(path)
    xyz = np.stack([props["x"], props["y"], props["z"]], 1).astype(np.float32)
    rgb = None
    if "red" in props:
        rgb = np.stack(
            [props["red"], props["green"], props["blue"]], 1
        ).astype(np.float32)
    label = props.get("label")
    if label is not None:
        label = np.asarray(label).astype(np.int32)
    return xyz, rgb, label
