"""Pure-Python TFRecord + tf.train.Example codec (the port's copy of
``pyspark_tf_gke_tpu/data/codec.py``).

CRC32C-masked record framing, and Examples whose features are
fixed-size FloatList/Int64List/BytesList (the schema contract of the
ETL bridge). The bytes it writes are the JAX codec's, and each package
reads the other's shards. The native C++ reader of the JAX package is
not ported (ROADMAP, P12).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

Schema = Dict[str, Tuple[str, Tuple[int, ...]]]

_KIND_DTYPE = {"float": np.float32, "int": np.int64, "bytes": np.uint8}

# ---------------------------------------------------------------------------
# crc32c
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _table():
    # a list of Python ints: the byte loop below indexes it once a byte
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


def encode_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


def iter_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) != 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (hcrc,) = struct.unpack("<I", header[8:])
            if masked_crc32c(header[:8]) != hcrc:
                raise ValueError(f"{path}: header CRC mismatch")
            payload = f.read(length)
            footer = f.read(4)
            if len(payload) != length or len(footer) != 4:
                raise ValueError(f"{path}: truncated record payload")
            if masked_crc32c(payload) != struct.unpack("<I", footer)[0]:
                raise ValueError(f"{path}: payload CRC mismatch")
            yield payload


# ---------------------------------------------------------------------------
# protobuf wire helpers
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint overflow")


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# Example encode / parse
# ---------------------------------------------------------------------------


def encode_example(schema: Schema, row: Dict[str, np.ndarray]) -> bytes:
    features = b""
    for name, (kind, shape) in schema.items():
        arr = np.ascontiguousarray(row[name], dtype=_KIND_DTYPE[kind]).reshape(-1)
        if kind == "float":
            list_payload = _len_delim(1, arr.astype("<f4").tobytes())
        elif kind == "int":
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in arr)
            list_payload = _len_delim(1, packed)
        else:
            list_payload = _len_delim(1, arr.tobytes())
        kind_field = {"bytes": 1, "float": 2, "int": 3}[kind]
        feature = _len_delim(kind_field, list_payload)
        entry = _len_delim(1, name.encode()) + _len_delim(2, feature)
        features += _len_delim(1, entry)
    return _len_delim(1, features)


def _parse_submessages(buf: bytes):
    """Yield (field, wire, payload_or_value) for one message level."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + n]
            pos += n
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_list(kind: str, feature_buf: bytes) -> np.ndarray:
    want_field = {"bytes": 1, "float": 2, "int": 3}[kind]
    for field, wire, payload in _parse_submessages(feature_buf):
        if field != want_field or wire != 2:
            continue
        if kind == "float":
            vals = []
            for f2, w2, p2 in _parse_submessages(payload):
                if f2 != 1:
                    continue
                if w2 == 2:
                    vals.append(np.frombuffer(p2, dtype="<f4"))
                elif w2 == 5:
                    vals.append(np.frombuffer(p2, dtype="<f4"))
            return np.concatenate(vals) if vals else np.empty(0, np.float32)
        if kind == "int":
            vals = []
            for f2, w2, p2 in _parse_submessages(payload):
                if f2 != 1:
                    continue
                if w2 == 2:
                    pos = 0
                    while pos < len(p2):
                        v, pos = _read_varint(p2, pos)
                        vals.append(v)
                elif w2 == 0:
                    vals.append(p2)
            return np.array(vals, dtype=np.uint64).astype(np.int64)
        for f2, w2, p2 in _parse_submessages(payload):
            if f2 == 1 and w2 == 2:
                return np.frombuffer(p2, dtype=np.uint8)
        return np.empty(0, np.uint8)
    raise KeyError(f"feature has no {kind} list")


def parse_example(schema: Schema, record: bytes) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for field, wire, features_buf in _parse_submessages(record):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _parse_submessages(features_buf):
            if f2 != 1 or w2 != 2:
                continue
            key = None
            feature = None
            for f3, w3, p3 in _parse_submessages(entry):
                if f3 == 1 and w3 == 2:
                    key = p3.decode()
                elif f3 == 2 and w3 == 2:
                    feature = p3
            if key is None or feature is None or key not in schema:
                continue
            kind, shape = schema[key]
            arr = _parse_list(kind, feature)
            expect = int(np.prod(shape, dtype=np.int64)) or 1
            if arr.size != expect:
                raise ValueError(
                    f"feature {key!r}: got {arr.size} elements, schema says {expect}"
                )
            out[key] = arr.reshape(shape) if shape else arr.reshape(())
    missing = set(schema) - set(out)
    if missing:
        raise KeyError(f"record missing features: {sorted(missing)}")
    return out
