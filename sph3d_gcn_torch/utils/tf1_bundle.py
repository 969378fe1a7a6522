"""Reader and writer of TF1 tensor-bundle checkpoints, numpy only
(counterpart of ``sph3d_gcn_tpu/utils/tf1_bundle.py``, byte for byte).

The reference publishes trained models as TF1 ``model.ckpt-*`` bundles
(ref README.md:70; saved by ``tf.train.Saver``, ref
modelnet40_cls/train_modelnet.py:188,254). A bundle is:

  <prefix>.index                 a LevelDB-format table mapping variable
                                 names to serialized BundleEntryProto
                                 records (dtype, shape, shard, offset,
                                 size), plus a "" header key
  <prefix>.data-NNNNN-of-MMMMM   raw little-endian tensor bytes

This module parses both without TensorFlow:

- the LevelDB table format: footer (magic 0xdb4775248b80fb57), BlockHandle
  varints, prefix-compressed key/value entries, restart arrays, and
  snappy block decompression (TF writes bundle tables uncompressed, but
  the decoder is included for robustness);
- the BundleHeaderProto / BundleEntryProto / TensorShapeProto protobuf
  wire encodings (hand-rolled, like the TFRecord codec in
  data/tfrecord.py).

``write_bundle`` emits a minimal valid bundle (single data block, no
compression), so the round trip is testable without TF and conversion
tooling can re-save bundles.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# LevelDB tables and bundle entries carry the masked crc32c of the
# TFRecord framing
from sph3d_gcn_torch.data.tfrecord import _masked_crc

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (tensorflow/core/framework/types.proto)
_DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16 (bit pattern; caller reinterprets)
    17: np.dtype("<u2"),  # DT_UINT16
    22: np.dtype("<u4"),  # DT_UINT32
    23: np.dtype("<u8"),  # DT_UINT64
}
_DTYPE_CODES = {
    np.dtype("float32"): 1,
    np.dtype("float64"): 2,
    np.dtype("int32"): 3,
    np.dtype("int64"): 9,
    np.dtype("bool"): 10,
}


# ------------------------------ varints --------------------------------

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


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ------------------------------ snappy ---------------------------------

def _snappy_decompress(data: bytes) -> bytes:
    """Minimal snappy raw-format decoder (literals + copy tags)."""
    length, pos = _read_varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 0x3
        if kind == 0:  # literal
            size = (tag >> 2) + 1
            if size > 60:
                extra = size - 60
                size = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            out += data[pos:pos + size]
            pos += size
        else:
            if kind == 1:  # copy with 1-byte offset
                size = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:  # copy with 2-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:  # copy with 4-byte offset
                size = (tag >> 2) + 1
                offset = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            start = len(out) - offset
            for i in range(size):  # may self-overlap
                out.append(out[start + i])
    if len(out) != length:
        raise ValueError(
            f"snappy: expected {length} bytes, got {len(out)}"
        )
    return bytes(out)


# --------------------------- protobuf wire -----------------------------

def _iter_proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            value = buf[pos:pos + size]
            pos += size
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1;}."""
    dims = []
    for field, _wire, value in _iter_proto_fields(buf):
        if field == 2:
            size = 0
            for f2, _w2, v2 in _iter_proto_fields(value):
                if f2 == 1:
                    size = v2
            dims.append(int(size))
    return tuple(dims)


def _parse_entry(buf: bytes) -> dict:
    """BundleEntryProto: dtype=1 shape=2 shard_id=3 offset=4 size=5
    crc32c=6 slices=7."""
    entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
             "crc32c": 0, "slices": 0}
    for field, wire, value in _iter_proto_fields(buf):
        if field == 1:
            entry["dtype"] = int(value)
        elif field == 2:
            entry["shape"] = _parse_shape(value)
        elif field == 3:
            entry["shard_id"] = int(value)
        elif field == 4:
            entry["offset"] = int(value)
        elif field == 5:
            entry["size"] = int(value)
        elif field == 6:
            entry["crc32c"] = (
                struct.unpack("<I", value)[0] if wire == 5 else int(value)
            )
        elif field == 7:
            entry["slices"] += 1
    return entry


def _parse_header(buf: bytes) -> dict:
    """BundleHeaderProto: num_shards=1 endianness=2."""
    header = {"num_shards": 1, "endianness": 0}
    for field, _wire, value in _iter_proto_fields(buf):
        if field == 1:
            header["num_shards"] = int(value)
        elif field == 2:
            header["endianness"] = int(value)
    return header


def _key(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _encode_entry(dtype_code, shape, shard_id, offset, size,
                  crc: int = 0) -> bytes:
    shape_buf = b"".join(
        _key(2, 2)
        + _write_varint(len(dim_buf := _key(1, 0) + _write_varint(d)))
        + dim_buf
        for d in shape
    )
    out = _key(1, 0) + _write_varint(dtype_code)
    out += _key(2, 2) + _write_varint(len(shape_buf)) + shape_buf
    if shard_id:
        out += _key(3, 0) + _write_varint(shard_id)
    out += _key(4, 0) + _write_varint(offset)
    out += _key(5, 0) + _write_varint(size)
    if crc:
        out += _key(6, 5) + struct.pack("<I", crc)
    return out




# ---------------------------- table format -----------------------------

def _parse_block(data: bytes) -> list[tuple[bytes, bytes]]:
    """LevelDB data block -> [(key, value)] (prefix-compressed entries)."""
    if len(data) < 4:
        return []
    num_restarts = struct.unpack("<I", data[-4:])[0]
    end = len(data) - 4 - 4 * num_restarts
    entries = []
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _read_varint(data, pos)
        unshared, pos = _read_varint(data, pos)
        value_len, pos = _read_varint(data, pos)
        key = key[:shared] + data[pos:pos + unshared]
        pos += unshared
        value = data[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_table_block(buf: bytes, offset: int, size: int) -> bytes:
    """Read a block given its handle; the 5-byte trailer after the block
    holds (compression_type, masked crc32c of block+type).

    The CRC is verified when nonzero (our own writer stores 0; TF always
    stores a real one) — a mismatch means on-disk corruption and raises
    rather than returning silently-wrong tensors."""
    if offset + size + 5 > len(buf):
        raise ValueError(
            f"table block at offset {offset} (+{size}+5 trailer) runs past "
            f"the file end ({len(buf)} bytes): truncated index file"
        )
    data = buf[offset:offset + size]
    compression = buf[offset + size]
    stored_crc = struct.unpack("<I", buf[offset + size + 1:offset + size + 5])[0]
    if stored_crc:
        got = _masked_crc(buf[offset:offset + size + 1])
        if got != stored_crc:
            raise ValueError(
                f"table block at offset {offset}: crc32c mismatch "
                f"(stored {stored_crc:#010x}, computed {got:#010x}) — "
                "the .index file is corrupted"
            )
    if compression == 0:
        return data
    if compression == 1:
        return _snappy_decompress(data)
    raise ValueError(
        f"table block at offset {offset}: unsupported compression type "
        f"{compression} (0=none and 1=snappy are the formats TF writes)"
    )


def _read_handle(buf: bytes, pos: int) -> tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_index(path: str) -> tuple[dict, dict[str, dict]]:
    """Parse a ``.index`` file -> (header, {variable_name: entry})."""
    with open(path, "rb") as f:
        buf = f.read()
    footer = buf[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF table file (bad magic)")
    _meta_off, _meta_size, pos = _read_handle(footer, 0)
    index_off, index_size, pos = _read_handle(footer, pos)
    index_block = _read_table_block(buf, index_off, index_size)
    header = None
    entries: dict[str, dict] = {}
    for _key_bytes, handle in _parse_block(index_block):
        off, size, _ = _read_handle(handle, 0)
        for key, value in _parse_block(_read_table_block(buf, off, size)):
            name = key.decode("utf-8", errors="replace")
            if name == "":
                header = _parse_header(value)
            else:
                entries[name] = _parse_entry(value)
    if header is None:
        raise ValueError(f"{path}: bundle header missing")
    return header, entries


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_bundle(prefix: str) -> dict[str, np.ndarray]:
    """Read every tensor of a TF1 checkpoint bundle.

    Args:
      prefix: checkpoint prefix (e.g. ``log/model.ckpt-100``) — the same
        string TF1's ``Saver.restore`` takes.

    Returns:
      {variable_name: array}; slice-partitioned variables are not
      supported (the reference saves whole variables only).
    """
    header, entries = read_index(prefix + ".index")
    shards: dict[int, bytes] = {}
    out: dict[str, np.ndarray] = {}
    for name, entry in sorted(entries.items()):
        if entry["slices"]:
            raise ValueError(
                f"{name}: slice-partitioned variable ({entry['slices']} "
                "slices) — the reference saves whole variables only "
                "(ref train_modelnet.py:188); re-save the checkpoint "
                "without a PartitionedVariable"
            )
        shard = entry["shard_id"]
        if shard not in shards:
            path = _shard_path(prefix, shard, header["num_shards"])
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{name}: data shard {path} missing (the bundle header "
                    f"declares {header['num_shards']} shard(s); copy ALL "
                    f"{prefix}.data-* files next to the .index)"
                )
            with open(path, "rb") as f:
                shards[shard] = f.read()
        dtype = _DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(
                f"{name}: unsupported dtype code {entry['dtype']}"
            )
        end = entry["offset"] + entry["size"]
        if end > len(shards[shard]):
            raise ValueError(
                f"{name}: tensor bytes [{entry['offset']}, {end}) run past "
                f"shard {shard}'s {len(shards[shard])} bytes: truncated "
                ".data file"
            )
        raw = shards[shard][entry["offset"]:end]
        if entry["crc32c"]:
            got = _masked_crc(raw)
            if got != entry["crc32c"]:
                raise ValueError(
                    f"{name}: tensor crc32c mismatch (stored "
                    f"{entry['crc32c']:#010x}, computed {got:#010x}) — the "
                    ".data file is corrupted"
                )
        arr = np.frombuffer(raw, dtype=dtype)
        out[name] = arr.reshape(entry["shape"]).copy()
    return out


# ------------------------------ writer ---------------------------------

def _block_with_trailer(payload: bytes) -> bytes:
    """Uncompressed block + (type, masked-crc32c) trailer — the real
    checksum, so readers that verify (ours does when nonzero) accept the
    bundle and detect later corruption."""
    block = payload + b"\x00"
    return block + struct.pack("<I", _masked_crc(block))


def _make_block(entries: list[tuple[bytes, bytes]]) -> bytes:
    """Single-restart block with no prefix compression (valid, simple)."""
    out = bytearray()
    for key, value in entries:
        out += _write_varint(0)            # shared
        out += _write_varint(len(key))     # unshared
        out += _write_varint(len(value))
        out += key + value
    out += struct.pack("<I", 0)            # restart point 0
    out += struct.pack("<I", 1)            # num restarts
    return bytes(out)


def write_bundle(prefix: str, tensors: dict[str, np.ndarray]) -> None:
    """Write a minimal single-shard TF1 bundle readable by TF and by
    :func:`read_bundle` (used by tests and conversion tooling)."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    data = bytearray()
    items = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        offset = len(data)
        raw = arr.tobytes()
        data += raw
        items.append((name, code, arr.shape, offset, len(raw),
                      _masked_crc(raw)))
    with open(_shard_path(prefix, 0, 1), "wb") as f:
        f.write(bytes(data))

    header = _key(1, 0) + _write_varint(1)  # num_shards = 1
    kv = [(b"", header)]
    for name, code, shape, offset, size, crc in items:
        kv.append(
            (name.encode(), _encode_entry(code, shape, 0, offset, size, crc))
        )
    data_block = _make_block(kv)
    buf = bytearray()
    buf += _block_with_trailer(data_block)

    meta_off = len(buf)
    meta_block = _make_block([])
    buf += _block_with_trailer(meta_block)

    index_off = len(buf)
    handle = _write_varint(0) + _write_varint(len(data_block))
    index_block = _make_block([(b"\xff", handle)])
    buf += _block_with_trailer(index_block)

    footer = bytearray()
    footer += _write_varint(meta_off) + _write_varint(len(meta_block))
    footer += _write_varint(index_off) + _write_varint(len(index_block))
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(buf) + bytes(footer))
