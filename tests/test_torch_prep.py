"""The port's data preparation functions (``sph3d_gcn_torch/data/prep``)
against the JAX package's on the same seeded inputs: every output equal,
bit for bit.

- ``voxelize``: ``grid_average_downsample`` (with and without attributes,
  several voxel sizes), ``majority_label`` and ``knn_transfer``;
- ``blocks``: ``_grid_starts``, ``cut_blocks`` (overlapping, without
  overlap, blocks merged into their neighbours or dropped) and
  ``normalize_room``;
- ``ply``: ``read_ply`` and ``read_ply_xyz_rgb`` on ascii and binary
  little-endian files the test writes (with a face element of list
  properties after the vertices, and a label property);
- ``scannet.prepare_scene`` (a train scene with out-of-range labels, a
  test scene without labels);
- ``shapenet``: ``remove_singular_points`` (with and without a small
  part), ``normalize_shape``, ``make_shapenet_records`` (the record file
  byte for byte);
- ``ruemonge``: the colour maps (an unknown colour raises on both sides),
  the axis swap and ``split_facade_blocks``;
- ``modelnet.prepare_shape`` on the CPU: JAX's XLA farthest-point
  sampling against the port's plain version, then the normalization
  (more points than asked, as many, fewer: both raise).
"""

import struct

import numpy as np
import pytest

from sph3d_gcn_torch.data.prep import blocks as tblocks
from sph3d_gcn_torch.data.prep import modelnet as tmodelnet
from sph3d_gcn_torch.data.prep import ply as tply
from sph3d_gcn_torch.data.prep import ruemonge as truemonge
from sph3d_gcn_torch.data.prep import scannet as tscannet
from sph3d_gcn_torch.data.prep import shapenet as tshapenet
from sph3d_gcn_torch.data.prep import voxelize as tvox
from sph3d_gcn_tpu.data.prep import blocks as jblocks
from sph3d_gcn_tpu.data.prep import modelnet as jmodelnet
from sph3d_gcn_tpu.data.prep import ply as jply
from sph3d_gcn_tpu.data.prep import ruemonge as jruemonge
from sph3d_gcn_tpu.data.prep import scannet as jscannet
from sph3d_gcn_tpu.data.prep import shapenet as jshapenet
from sph3d_gcn_tpu.data.prep import voxelize as jvox
from test_torch_cli import one_torch_thread  # noqa: F401


def _equal(got, ref):
    """Equal values, dtypes and shapes, through tuples and lists."""
    if isinstance(ref, (tuple, list)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
    elif ref is None:
        assert got is None
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def _room(n=20000, dims=(4.0, 3.0, 2.5), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 3)) * dims + (10.0, -3.0, 0.5)).astype(
        np.float32)


@pytest.mark.parametrize("voxel", [0.03, 0.1, 0.37])
@pytest.mark.parametrize("with_attr", [False, True])
def test_grid_average_downsample(voxel, with_attr):
    xyz = _room(5000, seed=1)
    attr = (np.random.default_rng(2).uniform(0, 255, (5000, 3)).astype(
        np.float32) if with_attr else None)
    got = tvox.grid_average_downsample(xyz, attr, voxel)
    _equal(got, jvox.grid_average_downsample(xyz, attr, voxel))
    assert len(got[0]) < 5000 or voxel == 0.03


def test_majority_label_and_knn_transfer():
    rng = np.random.default_rng(3)
    xyz = _room(4000, seed=3)
    labels = rng.integers(0, 13, 4000)
    _, _, inverse = tvox.grid_average_downsample(xyz, None, 0.2)
    num = int(inverse.max()) + 1
    _equal(tvox.majority_label(labels, inverse, num),
           jvox.majority_label(labels, inverse, num))
    dst = _room(1000, seed=4)
    _equal(tvox.knn_transfer(xyz, labels, dst),
           jvox.knn_transfer(xyz, labels, dst))


@pytest.mark.parametrize("lo,hi,size,interval", [
    (0.0, 4.0, 1.5, 0.75), (0.0, 1.0, 1.5, 0.75), (-2.0, 3.5, 1.5, 1.5),
    (0.1, 3.05, 1.0, 0.3)])
def test_grid_starts(lo, hi, size, interval):
    _equal(tblocks._grid_starts(lo, hi, size, interval),
           jblocks._grid_starts(lo, hi, size, interval))


@pytest.mark.parametrize("kwargs", [
    dict(),                                             # the defaults
    dict(block_size=1.5, interval=0.75, context=0.3, min_points=1000),
    dict(block_size=1.0, interval=2.0, context=0.1, min_points=500),
    # most blocks too small: merged into neighbours or dropped
    dict(block_size=1.0, interval=0.5, context=0.2, min_points=2600),
])
def test_cut_blocks(kwargs):
    rng = np.random.default_rng(5)
    xyz = _room(20000, seed=5)
    # a sparse corner, so that some blocks merge and some are dropped
    keep = (xyz[:, 0] > 12.5) | (xyz[:, 1] > -1.0) | (rng.random(20000)
                                                      < 0.1)
    xyz, _ = tblocks.normalize_room(xyz[keep])
    got = tblocks.cut_blocks(xyz, **kwargs)
    ref = jblocks.cut_blocks(xyz, **kwargs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _equal((g.index, g.inner), (r.index, r.inner))


def test_normalize_room():
    xyz = _room(3000, seed=6)
    _equal(tblocks.normalize_room(xyz), jblocks.normalize_room(xyz))


def _write_ply(path, fmt, xyz, rgb, label=None, faces=()):
    props = ["float x", "float y", "float z", "uchar red", "uchar green",
             "uchar blue"] + (["int label"] if label is not None else [])
    head = ["ply", f"format {fmt} 1.0", "comment written by a test",
            f"element vertex {len(xyz)}"]
    head += [f"property {p}" for p in props]
    head += [f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        for i in range(len(xyz)):
            row = list(xyz[i]) + list(rgb[i]) + (
                [label[i]] if label is not None else [])
            if fmt == "ascii":
                f.write((" ".join(str(v) for v in row) + "\n").encode())
            else:
                fmt_row = "<fffBBB" + ("i" if label is not None else "")
                f.write(struct.pack(fmt_row, *row))
        for face in faces:
            if fmt == "ascii":
                f.write((f"{len(face)} " + " ".join(map(str, face))
                         + "\n").encode())
            else:
                f.write(struct.pack(f"<B{len(face)}i", len(face), *face))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
@pytest.mark.parametrize("labelled", [False, True])
def test_read_ply(tmp_path, fmt, labelled):
    rng = np.random.default_rng(7)
    n = 50
    xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    label = rng.integers(0, 41, n).astype(np.int32) if labelled else None
    path = str(tmp_path / "scene.ply")
    _write_ply(path, fmt, xyz, rgb, label, faces=[(0, 1, 2), (3, 4, 5, 6)])
    got = tply.read_ply(path)
    ref = jply.read_ply(path)
    assert list(got) == list(ref)
    for k in ref:
        _equal(got[k], ref[k])
    got = tply.read_ply_xyz_rgb(path)
    _equal(got, jply.read_ply_xyz_rgb(path))
    if fmt != "ascii":
        np.testing.assert_array_equal(got[0], xyz)
    np.testing.assert_array_equal(got[1], rgb.astype(np.float32))


def test_read_ply_rejects_other_files(tmp_path):
    path = tmp_path / "x.ply"
    path.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tply.read_ply(str(path))


@pytest.mark.parametrize("labelled", [True, False])
def test_scannet_prepare_scene(labelled):
    rng = np.random.default_rng(8)
    xyz = _room(6000, (3.0, 2.0, 2.0), seed=8)
    rgb = rng.uniform(0, 255, (6000, 3)).astype(np.float32)
    label = rng.integers(0, 45, 6000) if labelled else None  # 0, 41-44 out
    got = tscannet.prepare_scene(xyz, rgb, label, voxel=0.1)
    _equal(got, jscannet.prepare_scene(xyz, rgb, label, voxel=0.1))
    assert (got[2] is None) == (not labelled)


def _shape(rng, n=400, small_part=True):
    xyz = rng.standard_normal((n, 3)).astype(np.float32) * (1.0, 0.5, 2.0)
    label = rng.integers(1, 4, n).astype(np.int32)
    if small_part:                       # a part of 6 points, two far out
        label[:6] = 4
        xyz[:2] += 5.0
    return xyz.astype(np.float32), label


@pytest.mark.parametrize("small_part", [False, True])
def test_shapenet_normalize_and_singular_points(small_part):
    rng = np.random.default_rng(9)
    xyz, label = _shape(rng, small_part=small_part)
    norm = tshapenet.normalize_shape(xyz)
    _equal(norm, jshapenet.normalize_shape(xyz))
    got = tshapenet.remove_singular_points(norm, label)
    _equal(got, jshapenet.remove_singular_points(norm, label))
    assert (got[2] > 0) == small_part


def test_shapenet_records_equal_bytes(tmp_path):
    rng = np.random.default_rng(10)
    shapes = []
    for cls in (0, 2, 2):
        xyz, label = _shape(rng, 300)
        shapes.append((jshapenet.normalize_shape(xyz), label, cls))
    offset = {0: 0, 2: 7}
    tshapenet.make_shapenet_records(shapes, offset, str(tmp_path / "t.rec"))
    jshapenet.make_shapenet_records(shapes, offset, str(tmp_path / "j.rec"))
    assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec"
                                                 ).read_bytes()
    got = tshapenet.load_shapenet_records([str(tmp_path / "t.rec")])
    ref = jshapenet.load_shapenet_records([str(tmp_path / "j.rec")])
    for g, r in zip(got, ref, strict=True):
        assert sorted(g) == sorted(r)
        for k in r:
            _equal(g[k], r[k])


def test_ruemonge_maps_and_axes():
    rng = np.random.default_rng(11)
    label = rng.integers(0, 7, 200)
    rgb = jruemonge.label2rgb(label)
    _equal(truemonge.label2rgb(label), rgb)
    _equal(truemonge.rgb2label(rgb), jruemonge.rgb2label(rgb))
    bad = rgb.copy()
    bad[5] = (1, 2, 3)
    for fn in (truemonge.rgb2label, jruemonge.rgb2label):
        with pytest.raises(ValueError, match="not found"):
            fn(bad)
    xyz = rng.standard_normal((100, 3)).astype(np.float32)
    _equal(truemonge.swap_axes_z_up(xyz), jruemonge.swap_axes_z_up(xyz))


@pytest.mark.parametrize("min_points", [100, 300, 5000])
def test_ruemonge_split_facade_blocks(min_points):
    rng = np.random.default_rng(12)
    xyz = rng.uniform(0, 20, (2000, 3)).astype(np.float32)
    # splits by x band (0 = unlabelled), two of them small
    split = (xyz[:, 0] // 4).astype(np.int64)
    split[rng.random(2000) < 0.02] = 7
    split[:15] = 9
    got = truemonge.split_facade_blocks(xyz, split, min_points)
    ref = jruemonge.split_facade_blocks(xyz, split, min_points)
    _equal(got, ref)


@pytest.mark.parametrize("n,num_point", [(900, 300), (1200, 1024),
                                         (256, 256)])
@pytest.mark.parametrize("with_normal", [True, False])
def test_modelnet_prepare_shape(n, num_point, with_normal):
    rng = np.random.default_rng(13)
    xyz = (rng.standard_normal((n, 3)) * (3.0, 1.0, 0.5) + 2.0).astype(
        np.float32)
    normal = (rng.standard_normal((n, 3)).astype(np.float32)
              if with_normal else None)
    got = tmodelnet.prepare_shape(xyz, normal, num_point, device="cpu")
    ref = jmodelnet.prepare_shape(xyz, normal, num_point)
    _equal(got, ref)
    assert got[0].shape == (num_point, 3)


def test_modelnet_prepare_shape_rejects_small_clouds():
    xyz = np.zeros((100, 3), np.float32)
    for fn in (lambda: tmodelnet.prepare_shape(xyz, None, 101,
                                               device="cpu"),
               lambda: jmodelnet.prepare_shape(xyz, None, 101)):
        with pytest.raises(ValueError, match="< requested 101"):
            fn()
