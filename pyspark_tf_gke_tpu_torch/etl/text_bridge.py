"""Packed-token TFRecord shards: the executor body of the Spark text
bridge and its metadata sidecar (the port's copy of
``pyspark_tf_gke_tpu/etl/text_bridge.py``, ``:31-131``).

* :func:`tokenize_partition_docs` tokenizes and eos-packs one
  partition's documents (``data/text.py``) and frames the rows as
  ``{"input_ids": int64[seq_len]}`` Examples into one shard
  ``{prefix}-{idx:05d}-of-{n:05d}.tfrecord`` through the port's codec
  (``data/codec.py``): on the same documents its bytes are the JAX
  body's;
* :func:`write_shard_metadata` writes the ``{prefix}.meta.json``
  sidecar (tokenizer, vocab size, seq_len) and
  :func:`validate_shard_meta` holds a consumer to it, with the JAX
  module's format string and messages.

Shards go to any local path or fsspec URL. The Spark action
``write_token_shards`` has no device part and is not ported (ROADMAP,
P12).
"""

from __future__ import annotations

import json
import logging
from typing import Iterable, Iterator, Optional

from pyspark_tf_gke_tpu_torch.data.codec import encode_example, encode_record
from pyspark_tf_gke_tpu_torch.utils.fs import fs_glob, fs_open

FORMAT = "pyspark_tf_gke_tpu.token_shards.v1"

logger = logging.getLogger("etl.text_bridge")


def tokenize_partition_docs(idx: int, docs: Iterable, output_prefix: str,
                            seq_len: int, tokenizer_spec: str = "byte",
                            num_shards: int = 16,
                            text_field: Optional[str] = None
                            ) -> Iterator[str]:
    """Executor body: tokenize and eos-pack this partition's documents
    (strings, or ``row[text_field]``-indexable records; empty and null
    texts are skipped) into one shard, streamed to its path; yields the
    path."""
    from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer, pack_tokens

    tokenizer = get_tokenizer(tokenizer_spec)
    schema = {"input_ids": ("int", (seq_len,))}
    raw = (d if text_field is None else d[text_field] for d in docs)
    texts = (t for t in raw if t)
    path = f"{output_prefix}-{idx:05d}-of-{num_shards:05d}.tfrecord"
    with fs_open(path, "wb") as out:
        for packed in pack_tokens(texts, tokenizer, seq_len):
            out.write(encode_record(encode_example(
                schema, {"input_ids": packed})))
    yield path


def write_shard_metadata(output_prefix: str, seq_len: int,
                         tokenizer_spec: str = "byte") -> str:
    """The sidecar ``{output_prefix}.meta.json``: the tokenizer and
    seq_len the shards were packed with."""
    from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer

    path = f"{output_prefix}.meta.json"
    meta = {
        "format": FORMAT,
        "tokenizer": tokenizer_spec,
        "vocab_size": get_tokenizer(tokenizer_spec).vocab_size,
        "seq_len": seq_len,
    }
    with fs_open(path, "wb") as fh:
        fh.write(json.dumps(meta, indent=2).encode())
    return path


def validate_shard_meta(pattern: str, tokenizer_spec: str, seq_len: int,
                        vocab_size: int) -> None:
    """Hold a consumer's tokenizer, seq_len and vocab to the sidecar
    beside the first matching shard: no sidecar warns (shards older than
    the sidecar), a mismatch raises."""
    matches = fs_glob(pattern)
    if not matches:
        return  # the reader fails loudly on its own
    base = matches[0].rsplit("-", 3)[0]
    sidecar = f"{base}.meta.json"
    try:
        with fs_open(sidecar, "rb") as fh:
            meta = json.loads(fh.read().decode())
    except (FileNotFoundError, OSError):
        logger.warning("no token-shard sidecar at %s; cannot verify the "
                       "tokenizer contract", sidecar)
        return
    problems = []
    if meta.get("tokenizer") != tokenizer_spec:
        problems.append(f"shards packed with tokenizer "
                        f"{meta.get('tokenizer')!r}, consumer uses "
                        f"{tokenizer_spec!r}")
    if int(meta.get("seq_len", seq_len)) != seq_len:
        problems.append(f"shards packed at seq_len {meta.get('seq_len')}, "
                        f"consumer expects {seq_len}")
    if int(meta.get("vocab_size", 0)) > vocab_size:
        problems.append(f"shard vocab {meta.get('vocab_size')} exceeds the "
                        f"model vocab {vocab_size}")
    if problems:
        raise ValueError("token-shard contract mismatch: "
                         + "; ".join(problems))
