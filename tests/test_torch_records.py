"""PyTorch port vs JAX: the TFRecord reader and writer and the dataset
pipelines, all bitwise.

- crc32c: the port's numpy version against the JAX module's (the C
  extension where installed) and a byte-loop model, on every length
  class of its lanes.
- Records written by JAX's ``TFRecordWriter`` read equal in the port
  (CRCs verified); the port's writer writes the same bytes; a corrupt
  record raises.
- ``load_modelnet_records``, ``modelnet_batches`` (shuffled, in order,
  short and dropped remainders), ``load_scene_blocks`` (xyz+rgb and
  xyz+normal+rgb, with the index map), ``resample_indices``,
  ``scene_batches`` and ``pad_batch``: equal to JAX's on the same
  generator state, and the generators end in the same state.
"""

import os

import numpy as np
import pytest

from sph3d_gcn_tpu.data import datasets as jax_datasets
from sph3d_gcn_tpu.data import tfrecord as jax_tfrecord
from sph3d_gcn_torch.data import datasets, tfrecord


def _examples(rng):
    return [
        {"xyz_raw": rng.standard_normal((37, 3)).astype(np.float32).tobytes(),
         "label": np.int64(7)},
        {"name": "chair_0001", "names": [b"a", b"bc", b""],
         "floats": rng.standard_normal(5).astype(np.float32),
         "ints": np.array([0, -1, 2 ** 40, -(2 ** 62)], np.int64),
         "flags": np.array([True, False])},
        {"empty": np.zeros(0, np.float32)},
    ]


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _byte_loop_crc(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [0, 1, 255, 256, 1023, 1024, 1025, 4 * 256 + 3,
                               70001])
def test_crc32c_matches(n):
    data = np.random.default_rng(n).bytes(n)
    assert tfrecord.crc32c(data) == jax_tfrecord._crc32c(data)
    if n <= 1025:
        assert tfrecord.crc32c(data) == _byte_loop_crc(data)


def test_records_cross_both_ways(tmp_path):
    examples = _examples(np.random.default_rng(0))
    jax_path, port_path = tmp_path / "jax.tfrecord", tmp_path / "port.tfrecord"
    with jax_tfrecord.TFRecordWriter(jax_path) as w:
        for ex in examples:
            w.write_example(ex)
    with tfrecord.TFRecordWriter(port_path) as w:
        for ex in examples:
            w.write_example(ex)
    assert jax_path.read_bytes() == port_path.read_bytes()
    got = list(tfrecord.read_examples(jax_path, verify_crc=True))
    ref = list(jax_tfrecord.read_examples(jax_path, verify_crc=True))
    assert len(got) == 3 and _equal(got, ref)
    assert got[0]["label"].tolist() == [7]
    assert got[1]["ints"].tolist() == [0, -1, 2 ** 40, -(2 ** 62)]
    assert [tfrecord.encode_example(ex) for ex in examples] == [
        jax_tfrecord.encode_example(ex) for ex in examples]

    raw = bytearray(port_path.read_bytes())
    raw[20] ^= 0xFF
    port_path.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_records(port_path, verify_crc=True))


def _modelnet_files(tmp_path, rng, sizes):
    files = []
    for i, n in enumerate(sizes):
        path = str(tmp_path / f"modelnet_{i}.tfrecord")
        with tfrecord.TFRecordWriter(path) as w:
            for j in range(n):
                w.write_example({
                    "xyz_raw": rng.standard_normal((64, 3)).astype(
                        np.float32).tobytes(),
                    "label": np.int64((7 * i + j) % 40)})
        files.append(path)
    return files


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True),
    dict(batch_size=4, shuffle=True, drop_remainder=True),
    dict(batch_size=3, shuffle=False),
])
def test_modelnet_pipeline_matches_jax(tmp_path, kw):
    files = _modelnet_files(tmp_path, np.random.default_rng(1), (5, 6))
    got = datasets.load_modelnet_records(files)
    ref = jax_datasets.load_modelnet_records(files)
    assert [(e.label, e.xyz.tobytes()) for e in got] == [
        (e.label, e.xyz.tobytes()) for e in ref]
    rngs = [np.random.default_rng(9), np.random.default_rng(9)]
    ours = list(datasets.modelnet_batches(got, rng=rngs[0], **kw))
    theirs = list(jax_datasets.modelnet_batches(ref, rng=rngs[1], **kw))
    assert len(ours) == len(theirs) >= 2 and _equal(ours, theirs)
    assert rngs[0].random() == rngs[1].random()
    for b, jb in zip(ours, theirs):
        for size in (4, 5):
            padded, n = datasets.pad_batch(b, size)
            ref_padded, ref_n = jax_datasets.pad_batch(jb, size)
            assert n == ref_n and _equal(padded, ref_padded)


def _scene_files(tmp_path, rng, normals):
    files = []
    for i, sizes in enumerate(((300, 90), (150,))):
        path = str(tmp_path / f"Area_{i}_room.tfrecord")
        with tfrecord.TFRecordWriter(path) as w:
            for n in sizes:
                ex = {
                    "xyz_raw": rng.uniform(0, 1.5, (n, 3)).astype(
                        np.float32).tobytes(),
                    "rgb_raw": rng.random((n, 3)).astype(np.float32).tobytes(),
                    "seg_label": rng.integers(0, 13, n).astype(
                        np.int32).tobytes(),
                    "inner_label": rng.integers(0, 2, n).astype(
                        np.int32).tobytes(),
                    "index_label": np.arange(n, dtype=np.int32).tobytes(),
                }
                if normals:
                    ex["normal_raw"] = rng.standard_normal((n, 3)).astype(
                        np.float32).tobytes()
                w.write_example(ex)
        files.append(path)
    return files


@pytest.mark.parametrize("normals", [False, True])
def test_scene_pipeline_matches_jax(tmp_path, normals):
    files = _scene_files(tmp_path, np.random.default_rng(2), normals)
    for with_index in (False, True):
        got = datasets.load_scene_blocks(files, with_index=with_index)
        ref = jax_datasets.load_scene_blocks(files, with_index=with_index)
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert g.scene == r.scene == os.path.basename(
                files[0 if g is not got[2] else 1])[:-len(".tfrecord")]
            for k in ("points", "label", "inner", "index"):
                assert _equal(getattr(g, k), getattr(r, k)), k
    assert got[0].points.shape == (300, 9 if normals else 6)
    rngs = [np.random.default_rng(4), np.random.default_rng(4)]
    for num_point in (128, 200):
        for shuffle in (True, False):
            ours = list(datasets.scene_batches(got, 2, num_point, rngs[0],
                                               shuffle=shuffle))
            theirs = list(jax_datasets.scene_batches(ref, 2, num_point,
                                                     rngs[1], shuffle=shuffle))
            assert len(ours) == 2 and _equal(ours, theirs)
    for num, target in ((10, 20), (20, 10), (15, 15)):
        assert np.array_equal(
            datasets.resample_indices(num, target, rngs[0]),
            jax_datasets.resample_indices(num, target, rngs[1]))
    assert rngs[0].random() == rngs[1].random()


def test_malformed_example_raises():
    good = tfrecord.encode_example({"label": np.int64(3)})
    assert tfrecord.decode_example(good)["label"].tolist() == [3]
    for bad in (b"\x12\x00", good[:2] + b"\x1a" + good[3:]):
        with pytest.raises(ValueError, match="malformed"):
            tfrecord.decode_example(bad)
