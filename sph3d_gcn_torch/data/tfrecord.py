"""TFRecord files of ``tf.train.Example`` protos, without TensorFlow
(counterpart of ``sph3d_gcn_tpu/data/tfrecord.py``, byte for byte).

The reference stores every dataset as TFRecords of ``tf.train.Example``
protos (`io/make_tfrecord_*.py`). Both sides are here:

- the record framing: {uint64 length, masked crc32c(length), payload,
  masked crc32c(payload)} per record;
- a minimal protobuf wire-format codec for the Example message tree
  (Example > Features > map<string, Feature> > Bytes/Float/Int64List).

A file written here reads equal in the JAX package and the other way
round. crc32c uses the ``google_crc32c`` C extension when it is
installed, else :func:`crc32c` (numpy, ~50 MB/s on long payloads).
"""

from __future__ import annotations

import functools
import os
import struct
from collections.abc import Iterator

import numpy as np

_POLY = 0x82F63B78          # crc32c (Castagnoli), reflected
_CHUNK = 256                # bytes a lane of the vectorised crc32c takes


@functools.cache
def _table() -> np.ndarray:
    """The byte table of the reflected crc32c register update."""
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


def _bytes_update(crc: int, data) -> int:
    """The register after ``data`` (a byte loop, for short inputs)."""
    table = _table().tolist()
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


@functools.cache
def _zeros_tables() -> np.ndarray:
    """(4, 256): the register after ``_CHUNK`` zero bytes, by the bytes of
    the register before them (the update is linear over GF(2))."""
    basis = [_bytes_update(1 << bit, bytes(_CHUNK)) for bit in range(32)]
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for v in range(256):
            acc = 0
            for bit in range(8):
                if v >> bit & 1:
                    acc ^= basis[8 * k + bit]
            out[k, v] = acc
    return out


def crc32c(data: bytes) -> int:
    """crc32c of ``data``: lanes of ``_CHUNK`` bytes updated side by side
    from a zero register, then folded in order (a lane's register after
    the previous lanes is their register moved over ``_CHUNK`` zero bytes,
    xor its own)."""
    view = memoryview(data).cast("B")
    lanes = len(view) // _CHUNK
    crc = 0xFFFFFFFF
    if lanes >= 4:
        table = _table()
        block = np.frombuffer(view[: lanes * _CHUNK], np.uint8).reshape(
            lanes, _CHUNK).astype(np.uint32)
        reg = np.zeros(lanes, np.uint32)
        for j in range(_CHUNK):
            reg = table[(reg ^ block[:, j]) & 0xFF] ^ (reg >> 8)
        z0, z1, z2, z3 = (t.tolist() for t in _zeros_tables())
        for r in reg.tolist():
            crc = (z0[crc & 0xFF] ^ z1[crc >> 8 & 0xFF]
                   ^ z2[crc >> 16 & 0xFF] ^ z3[crc >> 24]) ^ r
        view = view[lanes * _CHUNK:]
    return _bytes_update(crc, view) ^ 0xFFFFFFFF


try:  # the C extension where it is installed
    import google_crc32c

    def _crc32c(data: bytes) -> int:
        return google_crc32c.value(data)

except ImportError:  # pragma: no cover - depends on the installation
    _crc32c = crc32c


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers (just enough for tf.train.Example)
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _expect(ok: bool, what: str) -> None:
    """A record's bytes come from outside the program: malformed ones
    raise."""
    if not ok:
        raise ValueError(f"malformed tf.train.Example: {what}")


def _tag(field: int, wire_type: int) -> int:
    return (field << 3) | wire_type


def _length_delimited(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out.extend(payload)
    return bytes(out)


def _encode_feature(value) -> bytes:
    """One Feature (field 1 bytes_list / 2 float_list / 3 int64_list)."""
    arr = np.asarray(value)
    if arr.dtype.kind in ("U", "S", "O") or isinstance(value, (bytes, str)):
        items = value if isinstance(value, (list, tuple)) else [value]
        payload = bytearray()
        for item in items:
            if isinstance(item, str):
                item = item.encode("utf-8")
            payload.extend(_length_delimited(1, item))
        return _length_delimited(1, bytes(payload))
    if arr.dtype.kind == "f":
        data = arr.astype("<f4").ravel().tobytes()
        inner = _length_delimited(1, data)  # packed floats, field 1
        return _length_delimited(2, inner)
    if arr.dtype.kind in ("i", "u", "b"):
        payload = bytearray()
        _write_varint(payload, _tag(1, 2))
        body = bytearray()
        for v in arr.ravel().tolist():
            _write_varint(body, v & 0xFFFFFFFFFFFFFFFF)
        _write_varint(payload, len(body))
        payload.extend(body)
        return _length_delimited(3, bytes(payload))
    raise TypeError(f"Unsupported feature dtype: {arr.dtype}")


def encode_example(features: dict) -> bytes:
    """Encode {name: value} into a serialized tf.train.Example.

    Values: bytes/str (BytesList), float arrays (FloatList), int arrays
    (Int64List). A float array meant as raw bytes (the reference's
    ``xyz_raw``, ref io/make_tfrecord_modelnet.py:117-120) is passed as
    ``arr.tobytes()``.
    """
    feats = bytearray()
    for name, value in features.items():
        entry = _length_delimited(1, name.encode("utf-8")) + _length_delimited(
            2, _encode_feature(value)
        )
        feats.extend(_length_delimited(1, entry))
    return _length_delimited(1, bytes(feats))


def _decode_bytes_list(body: bytes) -> list[bytes]:
    out = []
    p = 0
    while p < len(body):
        t, p = _read_varint(body, p)
        _expect(t >> 3 == 1, f"list field {t >> 3}")
        n, p = _read_varint(body, p)
        out.append(body[p: p + n])
        p += n
    return out


def _decode_float_list(body: bytes) -> np.ndarray:
    p = 0
    vals = []
    while p < len(body):
        t, p = _read_varint(body, p)
        _expect(t >> 3 == 1, f"list field {t >> 3}")
        if t & 7 == 2:  # packed
            n, p = _read_varint(body, p)
            vals.append(np.frombuffer(body, "<f4", n // 4, p))
            p += n
        else:  # unpacked fixed32
            vals.append(np.frombuffer(body, "<f4", 1, p))
            p += 4
    return np.concatenate(vals) if vals else np.zeros(0, "<f4")


def _decode_int64_list(body: bytes) -> np.ndarray:
    p = 0
    vals = []
    while p < len(body):
        t, p = _read_varint(body, p)
        _expect(t >> 3 == 1, f"list field {t >> 3}")
        if t & 7 == 2:
            n, p = _read_varint(body, p)
            end = p + n
            while p < end:
                v, p = _read_varint(body, p)
                vals.append(v)
        else:
            v, p = _read_varint(body, p)
            vals.append(v)
    return np.array(vals, np.uint64).astype(np.int64)


_LIST_DECODERS = {1: _decode_bytes_list, 2: _decode_float_list,
                  3: _decode_int64_list}


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        _expect(wire == 2, f"wire type {wire} in a Feature")
        size, pos = _read_varint(buf, pos)
        body = buf[pos: pos + size]
        pos += size
        if field in _LIST_DECODERS:
            return _LIST_DECODERS[field](body)
    return None


def decode_example(data: bytes) -> dict:
    """Decode a serialized tf.train.Example into {name: value}."""
    out = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        _expect(tag >> 3 == 1 and tag & 7 == 2, "no Example.features")
        size, pos = _read_varint(data, pos)
        feats = data[pos: pos + size]
        pos += size
        fpos = 0
        while fpos < len(feats):
            ftag, fpos = _read_varint(feats, fpos)
            _expect(ftag >> 3 == 1 and ftag & 7 == 2, "no Features.feature")
            fsize, fpos = _read_varint(feats, fpos)
            entry = feats[fpos: fpos + fsize]
            fpos += fsize
            name = None
            value = None
            epos = 0
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                esize, epos = _read_varint(entry, epos)
                body = entry[epos: epos + esize]
                epos += esize
                if etag >> 3 == 1:
                    name = body.decode("utf-8")
                else:
                    value = _decode_feature(body)
            out[name] = value
    return out


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


class TFRecordWriter:
    """Write TFRecord files that tf.data readers read."""

    def __init__(self, path: str | os.PathLike):
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def write_example(self, features: dict) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(
    path: str | os.PathLike, verify_crc: bool = False
) -> Iterator[bytes]:
    """Iterate the raw records of a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify_crc:
                if _masked_crc(header) != hcrc:
                    raise IOError(f"corrupt record header in {path}")
                if _masked_crc(data) != dcrc:
                    raise IOError(f"corrupt record payload in {path}")
            yield data


def read_examples(
    path: str | os.PathLike, verify_crc: bool = False
) -> Iterator[dict]:
    """Iterate the decoded Examples of a TFRecord file."""
    for record in read_records(path, verify_crc):
        yield decode_example(record)
