"""TFRecord shards: write and read them as numpy batches (the codec
branch of ``pyspark_tf_gke_tpu/data/native_tfrecord.py``, ``:41-62`` and
``:165-323``).

Same contract as the JAX module: shards named
``{prefix}-{i:05d}-of-{n:05d}.tfrecord`` with row ``i`` in shard ``i %
n``; reading sorts the files matching a pattern, stripes them over
processes (file ``j`` to process ``j % count``), shuffles rows through a
fixed-capacity reservoir (``ShuffleBuffer``, the tf.data
``shuffle(3000)`` analog) reseeded each epoch, repeats, drops the
remainder and casts int features to int32. Records go through the
pure-Python codec (``data/codec.py``), so the bytes are the JAX codec's
and each package reads the other's shards. The threaded writer and the
native C++ reader are not ported (ROADMAP, P12): the codec is the one
path, and shards are written one after another. Remote shards
(``gs://``, ``memory://``) are striped over processes first and then
staged through ``utils/fs.spool_local``, so a process downloads only its
own files, once.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from pyspark_tf_gke_tpu_torch.data.codec import (Schema, encode_example,
                                                 encode_record, iter_records,
                                                 parse_example)
from pyspark_tf_gke_tpu_torch.utils.fs import fs_glob, spool_local
from pyspark_tf_gke_tpu_torch.utils.seeding import DEFAULT_SEED, np_rng


def schema_for(arrays: Dict[str, np.ndarray]) -> Schema:
    """uint8 arrays as bytes, other integers as int, the rest float;
    each feature's shape is its array's row shape."""
    out: Schema = {}
    for k, v in arrays.items():
        if v.dtype == np.uint8:
            kind = "bytes"
        elif np.issubdtype(v.dtype, np.integer):
            kind = "int"
        else:
            kind = "float"
        out[k] = (kind, tuple(v.shape[1:]))
    return out


def write_tfrecord_shards(arrays: Dict[str, np.ndarray], path_prefix: str,
                          num_shards: int = 4,
                          schema: Optional[Schema] = None) -> Sequence[str]:
    """Write row-aligned arrays as ``num_shards`` TFRecord shards; returns
    their paths. A shard whose write fails is removed, never left torn."""
    if schema is None:
        schema = schema_for(arrays)
    n = len(next(iter(arrays.values())))
    for k, v in arrays.items():
        if len(v) != n:
            raise ValueError(f"array {k!r} length {len(v)} != {n}")
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    paths = [f"{path_prefix}-{shard:05d}-of-{num_shards:05d}.tfrecord"
             for shard in range(num_shards)]
    for shard, path in enumerate(paths):
        try:
            with open(path, "wb") as f:
                for i in range(shard, n, num_shards):
                    row = {k: arrays[k][i] for k in schema}
                    f.write(encode_record(encode_example(schema, row)))
        except BaseException:
            try:
                os.remove(path)
            except OSError:
                pass
            raise
    return paths


def _iter_rows(files: Sequence[str], schema: Schema,
               read_batch: int) -> Iterator[Dict[str, np.ndarray]]:
    """Decoded row blocks of up to ``read_batch`` rows, file by file."""
    rows = []
    for path in files:
        for rec in iter_records(path):
            rows.append(parse_example(schema, rec))
            if len(rows) == read_batch:
                yield {k: np.stack([r[k] for r in rows]) for k in schema}
                rows = []
    if rows:
        yield {k: np.stack([r[k] for r in rows]) for k in schema}


class ShuffleBuffer:
    """Fixed-capacity reservoir shuffle, the tf.data ``shuffle(buffer)``
    analog."""

    def __init__(self, capacity: int, seed: int = DEFAULT_SEED):
        self.capacity = capacity
        self._rng = np_rng(seed)
        self._rows: list = []

    def push_pop(self, row) -> Optional[object]:
        if len(self._rows) < self.capacity:
            self._rows.append(row)
            return None
        j = int(self._rng.integers(len(self._rows)))
        out = self._rows[j]
        self._rows[j] = row
        return out

    def drain(self) -> Iterator[object]:
        order = self._rng.permutation(len(self._rows))
        for j in order:
            yield self._rows[j]
        self._rows = []


def read_tfrecord_batches(pattern: str, schema: Schema, batch_size: int,
                          shuffle: bool = True, seed: int = DEFAULT_SEED,
                          repeat: bool = True, process_index: int = 0,
                          process_count: int = 1,
                          shuffle_buffer: int = 3000,
                          int_dtype=np.int32) -> Iterator[Dict[str, np.ndarray]]:
    """Stream this process's numpy batches from the TFRecord shards
    matching ``pattern`` (a local glob or an fsspec URL)."""
    files = fs_glob(pattern)
    if not files:
        raise FileNotFoundError(f"no TFRecord shards match {pattern!r}")
    local_files = files[process_index::process_count]
    if not local_files:
        raise ValueError(
            f"{len(files)} shards < {process_count} processes; write more "
            "shards")
    local_files = [spool_local(f) for f in local_files]

    def cast(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k: batch[k].astype(int_dtype) if kind == "int" else batch[k]
                for k, (kind, _) in schema.items()}

    while True:  # epoch loop (one pass unless repeat)
        if shuffle:
            buf = ShuffleBuffer(shuffle_buffer, seed=seed)
            seed += 1  # reshuffle differently each epoch, deterministically

            def rows():
                for block in _iter_rows(local_files, schema, batch_size):
                    n = len(next(iter(block.values())))
                    for i in range(n):
                        out = buf.push_pop({k: block[k][i] for k in schema})
                        if out is not None:
                            yield out
                yield from buf.drain()

            stash: list = []
            for row in rows():
                stash.append(row)
                if len(stash) == batch_size:
                    yield cast({k: np.stack([r[k] for r in stash])
                                for k in schema})
                    stash = []
            # drop the remainder (drop_remainder=True)
        else:
            pending: Dict[str, list] = {k: [] for k in schema}
            pending_rows = 0
            for block in _iter_rows(local_files, schema, batch_size):
                for k in schema:
                    pending[k].append(block[k])
                pending_rows += len(next(iter(block.values())))
                while pending_rows >= batch_size:
                    batch = {}
                    for k in schema:
                        stacked = np.concatenate(pending[k])
                        batch[k] = stacked[:batch_size]
                        pending[k] = [stacked[batch_size:]]
                    pending_rows -= batch_size
                    yield cast(batch)
        if not repeat:
            return
