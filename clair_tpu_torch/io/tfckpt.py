"""Pure-Python TensorFlow Saver-V2 checkpoint IO (no tensorflow needed).

The reference ships pretrained models as TF1 `tf.train.Saver` triplets
(model.data-00000-of-00001 / model.index / model.meta, README.md:231).
Their on-disk format:

- ``<prefix>.index`` is a LevelDB-style SSTable mapping variable names to
  serialized BundleEntryProto records (dtype, shape, shard, offset, size);
  the empty key holds a BundleHeaderProto (shard count, version).
- ``<prefix>.data-00000-of-00001`` is the raw little-endian tensor bytes at
  the recorded offsets.

This module parses (and, for test fixtures, writes) exactly that subset:
uncompressed blocks, single data shard, float32/int32/int64 tensors — all
the published reference checkpoints use. It exists so pretrained weights
convert to this framework on machines with no TensorFlow at all (TF 1.13
does not even install on modern Python).

Format references: tensorflow/core/util/tensor_bundle/tensor_bundle.cc
(BundleEntryProto field numbers), leveldb table_format.md (block layout,
restart arrays, 0xdb4775248b80fb57 footer magic), crc32c masking from
leveldb crc32c.h.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
BLOCK_RESTART_INTERVAL = 16

# TF DataType enum values we support
DT_FLOAT, DT_INT32, DT_INT64 = 1, 3, 9
_DTYPES = {
    DT_FLOAT: np.dtype("<f4"),
    DT_INT32: np.dtype("<i4"),
    DT_INT64: np.dtype("<i8"),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# varint + crc32c
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


def _read_varint(data: bytes, cursor: int) -> Tuple[int, int]:
    shift = 0
    value = 0
    while True:
        byte = data[cursor]
        cursor += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, cursor
        shift += 7


_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    # table-driven over plain Python ints: numpy scalar ops per byte were
    # ~50x slower, which mattered at multi-MB tensor payloads
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    # leveldb crc32c::Mask: rotate right 15 then ADD kMaskDelta — the
    # addend was missing until TF's own reader rejected our blocks
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encode/decode (only the fields the bundle uses)
# ---------------------------------------------------------------------------

def _pb_tag(field: int, wire: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    return bytes(out)


def _pb_varint_field(field: int, value: int) -> bytes:
    out = bytearray(_pb_tag(field, 0))
    _write_varint(out, value)
    return bytes(out)


def _pb_bytes_field(field: int, payload: bytes) -> bytes:
    out = bytearray(_pb_tag(field, 2))
    _write_varint(out, len(payload))
    return bytes(out) + payload


def _pb_fields(data: bytes) -> List[Tuple[int, int, object]]:
    """[(field, wire, value)] — varint values as int, length-delimited as
    bytes, fixed32/64 as int."""
    out = []
    cursor = 0
    while cursor < len(data):
        key, cursor = _read_varint(data, cursor)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, cursor = _read_varint(data, cursor)
        elif wire == 2:
            length, cursor = _read_varint(data, cursor)
            value = data[cursor:cursor + length]
            cursor += length
        elif wire == 5:
            value = struct.unpack_from("<I", data, cursor)[0]
            cursor += 4
        elif wire == 1:
            value = struct.unpack_from("<Q", data, cursor)[0]
            cursor += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.append((field, wire, value))
    return out


def _encode_shape(shape: Tuple[int, ...]) -> bytes:
    # TensorShapeProto: repeated Dim dim = 2; Dim.size = 1
    payload = b""
    for size in shape:
        payload += _pb_bytes_field(2, _pb_varint_field(1, size))
    return payload


def _decode_shape(payload: bytes) -> Tuple[int, ...]:
    dims = []
    for field, wire, value in _pb_fields(payload):
        if field == 2 and wire == 2:
            size = 0
            for f2, w2, v2 in _pb_fields(value):
                if f2 == 1 and w2 == 0:
                    size = v2
            dims.append(size)
    return tuple(dims)


def _encode_entry(dtype_code: int, shape, shard: int, offset: int, size: int,
                  crc: int) -> bytes:
    # BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5, crc32c=6
    out = b""
    out += _pb_varint_field(1, dtype_code)
    out += _pb_bytes_field(2, _encode_shape(shape))
    if shard:
        out += _pb_varint_field(3, shard)
    if offset:
        out += _pb_varint_field(4, offset)
    out += _pb_varint_field(5, size)
    out += _pb_tag(6, 5) + struct.pack("<I", crc)
    return out


def _decode_entry(payload: bytes):
    dtype_code, shape, shard, offset, size = DT_FLOAT, (), 0, 0, 0
    for field, wire, value in _pb_fields(payload):
        if field == 1:
            dtype_code = value
        elif field == 2:
            shape = _decode_shape(value)
        elif field == 3:
            shard = value
        elif field == 4:
            offset = value
        elif field == 5:
            size = value
    return dtype_code, shape, shard, offset, size


# ---------------------------------------------------------------------------
# SSTable blocks
# ---------------------------------------------------------------------------

def _build_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """LevelDB data block: prefix-compressed entries + restart array."""
    out = bytearray()
    restarts = []
    previous_key = b""
    for i, (key, value) in enumerate(entries):
        if i % BLOCK_RESTART_INTERVAL == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            for a, b in zip(previous_key, key):
                if a != b:
                    break
                shared += 1
        _write_varint(out, shared)
        _write_varint(out, len(key) - shared)
        _write_varint(out, len(value))
        out += key[shared:]
        out += value
        previous_key = key
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def _parse_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    data_end = len(block) - 4 - 4 * n_restarts
    entries = []
    cursor = 0
    key = b""
    while cursor < data_end:
        shared, cursor = _read_varint(block, cursor)
        non_shared, cursor = _read_varint(block, cursor)
        value_len, cursor = _read_varint(block, cursor)
        key = key[:shared] + block[cursor:cursor + non_shared]
        cursor += non_shared
        value = block[cursor:cursor + value_len]
        cursor += value_len
        entries.append((key, value))
    return entries


def _block_with_trailer(block: bytes) -> bytes:
    # trailer: compression type (0 = none) + masked crc over block+type
    trailer_crc = _masked_crc32c(block + b"\x00")
    return block + b"\x00" + struct.pack("<I", trailer_crc)


def _encode_handle(offset: int, size: int) -> bytes:
    out = bytearray()
    _write_varint(out, offset)
    _write_varint(out, size)
    return bytes(out)


def _read_handle(data: bytes, cursor: int) -> Tuple[int, int, int]:
    offset, cursor = _read_varint(data, cursor)
    size, cursor = _read_varint(data, cursor)
    return offset, size, cursor


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def read_index(index_path: str) -> Dict[str, Tuple[int, Tuple[int, ...], int, int, int]]:
    """{variable_name: (dtype_code, shape, shard, offset, size)}."""
    with open(index_path, "rb") as fh:
        raw = fh.read()
    footer = raw[-48:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise ValueError(f"{index_path} is not an SSTable (.index) file")
    cursor = 0
    _meta_offset, _meta_size, cursor = _read_handle(footer, cursor)
    index_offset, index_size, cursor = _read_handle(footer, cursor)

    index_block = raw[index_offset:index_offset + index_size]
    out: Dict[str, Tuple[int, Tuple[int, ...], int, int, int]] = {}
    for _key, handle in _parse_block(index_block):
        block_offset, block_size, _ = _read_handle(handle, 0)
        for key, value in _parse_block(raw[block_offset:block_offset + block_size]):
            if key == b"":
                continue  # BundleHeaderProto
            name = key.decode("utf-8")
            out[name] = _decode_entry(value)
    return out


def load_variables(prefix: str) -> Dict[str, np.ndarray]:
    """All tensors of a Saver-V2 checkpoint ``prefix`` (uses prefix.index +
    prefix.data-XXXXX-of-YYYYY)."""
    import glob
    import os
    import re

    entries = read_index(prefix + ".index")
    shards: Dict[int, bytes] = {}
    for path in glob.glob(prefix + ".data-*-of-*"):
        match = re.search(r"\.data-(\d+)-of-\d+$", os.path.basename(path))
        if match:
            with open(path, "rb") as fh:
                shards[int(match.group(1))] = fh.read()
    out: Dict[str, np.ndarray] = {}
    for name, (dtype_code, shape, shard, offset, size) in entries.items():
        if dtype_code not in _DTYPES:
            continue  # e.g. DT_STRING bookkeeping vars
        data = shards[shard][offset:offset + size]
        out[name] = np.frombuffer(data, dtype=_DTYPES[dtype_code]).reshape(shape)
    return out


def save_variables(prefix: str, variables: Dict[str, np.ndarray]) -> None:
    """Write a Saver-V2 checkpoint (single shard, uncompressed) readable by
    both this module and TensorFlow — used for fixtures and exports."""
    names = sorted(variables)
    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []

    # header entry at the empty key: BundleHeaderProto
    # num_shards=1 (field 1), endianness LITTLE=0 (field 2, default),
    # version (field 3): VersionDef{producer=1}
    header = _pb_varint_field(1, 1) + _pb_bytes_field(3, _pb_varint_field(1, 1))
    entries.append((b"", header))

    for name in names:
        arr = np.ascontiguousarray(variables[name])
        code = _DTYPE_CODES.get(arr.dtype.newbyteorder("<"))
        if code is None:
            if arr.dtype == np.float64:
                arr = arr.astype("<f4")
                code = DT_FLOAT
            else:
                raise ValueError(f"unsupported dtype {arr.dtype} for {name}")
        payload = arr.tobytes()
        entry = _encode_entry(
            code, arr.shape, 0, len(data), len(payload), _masked_crc32c(payload)
        )
        entries.append((name.encode("utf-8"), entry))
        data += payload

    with open(f"{prefix}.data-00000-of-00001", "wb") as fh:
        fh.write(bytes(data))

    # one data block holding every entry, one index block pointing at it
    out = bytearray()
    data_block = _build_block(entries)
    data_handle = _encode_handle(0, len(data_block))
    out += _block_with_trailer(data_block)

    meta_offset = len(out)
    meta_block = _build_block([])
    out += _block_with_trailer(meta_block)
    meta_handle = _encode_handle(meta_offset, len(meta_block))

    index_offset = len(out)
    # index key: any key >= last data-block key works; reuse the last key
    last_key = entries[-1][0] if entries else b""
    index_block = _build_block([(last_key, data_handle)])
    out += _block_with_trailer(index_block)
    index_handle = _encode_handle(index_offset, len(index_block))

    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", TABLE_MAGIC)
    out += footer
    with open(prefix + ".index", "wb") as fh:
        fh.write(bytes(out))
