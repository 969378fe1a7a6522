"""The native TFRecord reader: a small C++ core (``_native/loader.cc``)
bound with ``ctypes`` (counterpart of ``sph3d_gcn_tpu/data/native_loader.py``).

The C++ core walks a file's record framing (checking both CRCs of each
record on request), then reads every payload into one buffer; Python
slices out the records and decodes them with
``data.tfrecord.decode_example``. The Python reader of
``data/tfrecord.py`` is its plain version. With CRC checks this reader
is several times faster than the plain one (numpy's crc32c); without,
the plain one is faster (it copies each payload once, this reader three
times), and ``data.datasets`` reads through it (``chip_smoke.py`` phase
49 times both).

The library is built with ``g++ -O3 -std=c++17 -shared -fPIC`` at first
use, never at import, into ``.kernel_build/native_loader/<hash of the
source, the compiler and the flags>/`` beside the package; an unchanged
checkout reuses it. Each process compiles to a name of its own and moves
the result into place with ``os.replace``, so processes that build at once
do not see each other's half-written file. A failed build raises with the
compiler's output: nothing falls back to the Python reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from sph3d_gcn_torch.data.tfrecord import decode_example

SOURCE = Path(__file__).resolve().parent / "_native" / "loader.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".kernel_build"
LIB_NAME = "libsph3dloader.so"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
CXX = "g++"

_LIB: ctypes.CDLL | None = None

_ERRORS = {
    -1: "cannot open file",
    -2: "truncated record file",
    -3: "CRC mismatch (corrupt record)",
    -4: "capacity exceeded",
}


def build_dir(cxx: str | None = None) -> Path:
    """The build directory for the current source, compiler and flags."""
    h = hashlib.sha256(" ".join((cxx or CXX,) + FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / "native_loader" / h.hexdigest()[:16]


def build(cxx: str | None = None, out_dir: Path | None = None) -> Path:
    """Compile the reader if it is not built yet; returns the library's
    path. Raises RuntimeError with the compiler's output if it fails."""
    cxx = cxx or CXX
    out_dir = Path(out_dir) if out_dir is not None else build_dir(cxx)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [cxx, *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(
            f"building the native record reader failed: {' '.join(cmd)}: "
            f"{exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native record reader failed: {' '.join(cmd)} "
            f"({res.returncode}):\n{res.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded reader, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.sph3d_masked_crc32c.restype = ctypes.c_uint32
        lib.sph3d_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sph3d_tfrecord_scan.restype = ctypes.c_int64
        lib.sph3d_tfrecord_scan.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.c_int64, ctypes.c_int]
        lib.sph3d_tfrecord_read.restype = ctypes.c_int64
        lib.sph3d_tfrecord_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            i64p, i64p, ctypes.c_int64]
        _LIB = lib
    return _LIB


def masked_crc32c(data: bytes) -> int:
    """The masked crc32c of the record framing, computed by the C++ core."""
    return library().sph3d_masked_crc32c(data, len(data))


def read_records_native(
    path: str | os.PathLike, verify_crc: bool = False
) -> Iterator[bytes]:
    """The raw records of a TFRecord file: the C++ core walks the framing
    (checking both CRCs of every record when ``verify_crc``) and reads the
    payloads into one buffer. Raises IOError on a missing, truncated or
    corrupt file."""
    lib = library()
    path = os.fspath(path)
    cap = max(1024, os.path.getsize(path) // 16 + 16)  # a record >= 16 B
    offsets = np.zeros(cap, np.int64)
    lengths = np.zeros(cap, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    count = lib.sph3d_tfrecord_scan(
        path.encode(), offsets.ctypes.data_as(i64p),
        lengths.ctypes.data_as(i64p), cap, 1 if verify_crc else 0)
    if count < 0:
        raise IOError(f"{path}: {_ERRORS.get(count, 'read error')}")
    total = int(lengths[:count].sum())
    buf = np.zeros(total, np.uint8)
    got = lib.sph3d_tfrecord_read(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        total, offsets.ctypes.data_as(i64p), lengths.ctypes.data_as(i64p),
        count)
    if got < 0:
        raise IOError(f"{path}: {_ERRORS.get(got, 'read error')}")
    raw = buf.tobytes()
    pos = 0
    for n in lengths[:count].tolist():
        yield raw[pos: pos + n]
        pos += n


def read_examples_native(
    path: str | os.PathLike, verify_crc: bool = False
) -> Iterator[dict]:
    """The decoded Examples of a TFRecord file, read by the C++ core."""
    for record in read_records_native(path, verify_crc):
        yield decode_example(record)
