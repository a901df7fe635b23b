"""The ETL bridge's pure-Python TFRecord writers (the port's copy of
``pyspark_tf_gke_tpu/etl/tfrecord_bridge.py``, ``:51-138``): a
tf.train.Example per row, framed as a CRC-masked TFRecord, one shard a
partition, ``{prefix}-{idx:05d}-of-{n:05d}.tfrecord``. The shards are
the JAX writer's byte for byte. The Spark action that repartitions a
DataFrame and runs :func:`write_partition_rows` on each partition
(``write_dataframe_shards``) is P12's.
"""

from __future__ import annotations

import io
import struct
from typing import Iterable, Iterator, Optional, Sequence

from pyspark_tf_gke_tpu_torch.data.codec import (_len_delim, _varint,
                                                 encode_record)
from pyspark_tf_gke_tpu_torch.utils.fs import fs_open


def tfrecord_frame(payload: bytes) -> bytes:
    """One TFRecord: len(8) + masked_crc(len)(4) + payload +
    masked_crc(payload)(4)."""
    return encode_record(payload)


def _packed_floats(values: Sequence[float]) -> bytes:
    return _len_delim(1, b"".join(struct.pack("<f", v) for v in values))


def _packed_ints(values: Sequence[int]) -> bytes:
    return _len_delim(1, b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF)
                                  for v in values))


def example_bytes(row: dict) -> bytes:
    """A tf.train.Example for a ``{name: value}`` row, features in name
    order: str/bytes -> BytesList, int -> Int64List, a list of ints ->
    Int64List, any other list or number -> FloatList."""
    entries = b""
    for name, value in sorted(row.items()):
        if isinstance(value, (bytes, str)):
            v = value.encode() if isinstance(value, str) else value
            feat = _len_delim(1, _len_delim(1, v))
        elif isinstance(value, int):
            feat = _len_delim(3, _packed_ints([value]))
        elif isinstance(value, (list, tuple)):
            if all(isinstance(x, int) for x in value):
                feat = _len_delim(3, _packed_ints(value))
            else:
                feat = _len_delim(2, _packed_floats([float(x)
                                                     for x in value]))
        else:
            feat = _len_delim(2, _packed_floats([float(value)]))
        entry = _len_delim(1, name.encode()) + _len_delim(2, feat)
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)


def write_partition_rows(idx: int, rows: Iterable, output_prefix: str,
                         cols: Sequence[str], label_col: Optional[str] = None,
                         num_shards: int = 16) -> Iterator[str]:
    """The per-partition body: frame every row of ``rows`` (any iterable
    of ``row[col]``-indexable records) into one shard, at a local path or
    an fsspec URL; yields its path."""
    path = f"{output_prefix}-{idx:05d}-of-{num_shards:05d}.tfrecord"
    buf = io.BytesIO()
    for row in rows:
        d = {c: row[c] for c in cols}
        if label_col is not None:
            d[label_col] = row[label_col]
        buf.write(tfrecord_frame(example_bytes(d)))
    with fs_open(path, "wb") as fh:
        fh.write(buf.getvalue())
    yield path
