"""The port's native record reader (``sph3d_gcn_torch/data/native_loader.py``
and its C++ core ``data/_native/loader.cc``), built with the host's
``g++`` at first use, against the Python reader of ``data/tfrecord.py``
(its plain version):

- the masked crc32c against ``tfrecord._masked_crc`` on lengths around
  the core's 8-byte steps;
- the records and decoded Examples equal to the Python reader's, with and
  without CRC checks, on empty, one-record and many-record files, and
  to what ``data.datasets``' loaders (the Python reader) load;
- a flipped byte (a length, a payload or either's CRC) raises IOError,
  and so do a truncated file and a missing one;
- a failed build raises with the compiler's words, and so does a read
  after it: nothing falls back to the Python reader;
- two processes that build into one fresh directory at once both load a
  working library, and leave no temporary file.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sph3d_gcn_torch.data import datasets, native_loader, tfrecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(path, n=20, seed=0, points=100):
    rng = np.random.default_rng(seed)
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            w.write_example({
                "xyz_raw": rng.standard_normal((points + i, 3)).astype(
                    np.float32).tobytes(),
                "rgb_raw": rng.random((points + i, 3)).astype(
                    np.float32).tobytes(),
                "seg_label": rng.integers(0, 13, points + i).astype(
                    np.int32).tobytes(),
                "inner_label": np.ones(points + i, np.int32).tobytes(),
                "label": np.int64(i % 40),
            })
    return str(path)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4099])
def test_masked_crc_matches_python(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(
        np.uint8).tobytes()
    assert native_loader.masked_crc32c(data) == tfrecord._masked_crc(data)


@pytest.mark.parametrize("count", [0, 1, 25])
@pytest.mark.parametrize("verify_crc", [False, True])
def test_records_match_python(tmp_path, count, verify_crc):
    path = _write(tmp_path / "r.tfrecord", n=count)
    got = list(native_loader.read_records_native(path, verify_crc))
    assert got == list(tfrecord.read_records(path, verify_crc))
    assert len(got) == count
    ex = list(native_loader.read_examples_native(path, verify_crc))
    ref = list(tfrecord.read_examples(path, verify_crc))
    assert len(ex) == len(ref)
    for g, r in zip(ex, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]))


def test_datasets_load_what_the_native_reader_reads(tmp_path):
    path = _write(tmp_path / "blocks.tfrecord", n=6)
    blocks = datasets.load_scene_blocks([path])
    shapes = datasets.load_modelnet_records([path])
    ref = list(native_loader.read_examples_native(path, verify_crc=True))
    for blk, shape, ex in zip(blocks, shapes, ref, strict=True):
        xyz = np.frombuffer(ex["xyz_raw"][0], np.float32).reshape(-1, 3)
        np.testing.assert_array_equal(blk.points[:, :3], xyz)
        np.testing.assert_array_equal(shape.xyz, xyz)
        assert shape.label == int(ex["label"][0])


@pytest.mark.parametrize("where", ["length", "length_crc", "payload",
                                   "payload_crc"])
def test_corrupt_byte_raises(tmp_path, where):
    path = _write(tmp_path / "r.tfrecord", n=3)
    raw = bytearray(open(path, "rb").read())
    (length,) = np.frombuffer(bytes(raw[:8]), "<u8")
    pos = {"length": 2, "length_crc": 9, "payload": 12 + int(length) // 2,
           "payload_crc": 12 + int(length) + 1}[where]
    raw[pos] ^= 0x10
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="CRC mismatch"):
        list(native_loader.read_records_native(bad, verify_crc=True))
    if where != "length":   # the Python reader reads the bytes first
        with pytest.raises(IOError):
            list(tfrecord.read_records(bad, verify_crc=True))


def test_truncated_file_raises(tmp_path):
    path = _write(tmp_path / "r.tfrecord", n=3)
    raw = open(path, "rb").read()
    short = tmp_path / "short.tfrecord"
    short.write_bytes(raw[:-7])
    with pytest.raises(IOError, match="truncated"):
        list(native_loader.read_records_native(short, verify_crc=True))
    with pytest.raises(FileNotFoundError):
        list(native_loader.read_records_native(tmp_path / "missing"))


def test_failed_build_raises(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="native record reader"):
        native_loader.build(cxx=str(tmp_path / "no-such-compiler"),
                            out_dir=tmp_path / "a")
    # a compiler that runs and fails: its words are in the error
    fake = tmp_path / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'loader.cc:1: error: no luck' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no luck"):
        native_loader.build(cxx=str(fake), out_dir=tmp_path / "b")
    assert not (tmp_path / "b" / native_loader.LIB_NAME).exists()
    # a read after a failed build raises: no fall back to the Python reader
    path = _write(tmp_path / "r.tfrecord", n=2)
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "CXX", str(fake))
    monkeypatch.setattr(native_loader, "BUILD_ROOT", tmp_path / "root")
    with pytest.raises(RuntimeError, match="no luck"):
        list(native_loader.read_examples_native(path, verify_crc=True))


def test_two_processes_build_at_once(tmp_path):
    out_dir = tmp_path / "build"
    path = _write(tmp_path / "r.tfrecord", n=4)
    start = time.time() + 2.0
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "from sph3d_gcn_torch.data import native_loader as nl\n"
        f"time.sleep(max(0.0, {start} - time.time()))\n"
        "lib = nl.build(out_dir=Path(sys.argv[1]))\n"
        "nl._LIB = None\n"
        "nl.build = lambda: lib\n"
        "print(len(list(nl.read_records_native(sys.argv[2], True))))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out_dir),
                               path], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "4"
    assert sorted(os.listdir(out_dir)) == [native_loader.LIB_NAME]
