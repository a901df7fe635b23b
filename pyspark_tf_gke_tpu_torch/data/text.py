"""Text -> token-id pipeline (the port's copy of
``pyspark_tf_gke_tpu/data/text.py``).

* ``ByteTokenizer``: UTF-8 bytes 0..255 plus ``<pad>``/``<bos>``/
  ``<eos>`` (vocab 259).
* ``load_hf_tokenizer``: the adapter over a ``transformers``
  ``AutoTokenizer`` (a local directory written by ``save_pretrained``, or
  a name the local cache holds); ``transformers`` is imported only when
  a bundle names such a tokenizer.
* ``iter_documents`` / ``pack_tokens`` / ``lm_batches``: blank-line
  documents, eos-packed into fixed-length rows (optionally with
  per-document segment ids), through the same seeded reservoir shuffle
  as the JAX package, so the same corpus and seed give the same
  batches. Local files only (``utils/fs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Iterator, List, Sequence, Union

import numpy as np

from pyspark_tf_gke_tpu_torch.utils.fs import fs_glob, fs_open


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255 = bytes, then specials."""

    pad_id: int = 256
    bos_id: int = 257
    eos_id: int = 258

    @property
    def vocab_size(self) -> int:
        return 259

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


class HFTokenizerAdapter:
    """Uniform facade (encode/decode/vocab_size/eos_id/pad_id) over a
    ``transformers`` tokenizer, as the JAX package's."""

    def __init__(self, tok):
        self._tok = tok
        self.eos_id = (tok.eos_token_id if tok.eos_token_id is not None
                       else tok.sep_token_id or 0)
        self.pad_id = tok.pad_token_id if tok.pad_token_id is not None else 0
        self.vocab_size = int(len(tok))

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))


def load_hf_tokenizer(name_or_path: str) -> HFTokenizerAdapter:
    try:
        from transformers import AutoTokenizer
    except ImportError as exc:
        raise ImportError(
            "transformers is required for a tokenizer other than 'byte'"
        ) from exc
    return HFTokenizerAdapter(AutoTokenizer.from_pretrained(name_or_path))


def get_tokenizer(spec: str = "byte"
                  ) -> Union[ByteTokenizer, HFTokenizerAdapter]:
    """``byte`` -> ByteTokenizer; anything else -> an ``AutoTokenizer``
    name or directory."""
    if spec in ("", "byte"):
        return ByteTokenizer()
    return load_hf_tokenizer(spec)


def iter_documents(pattern: str, *, process_index: int = 0,
                   process_count: int = 1) -> Iterator[str]:
    """Blank-line-separated documents from the files matching
    ``pattern``; file ``i`` goes to process ``i % process_count``."""
    paths = fs_glob(pattern)
    if not paths:
        raise FileNotFoundError(f"no text files match {pattern!r}")
    for i, path in enumerate(paths):
        if i % process_count != process_index:
            continue
        with fs_open(path, "rb") as fh:
            buf: List[str] = []
            for raw in fh:
                line = raw.decode("utf-8", errors="replace").rstrip("\n")
                if line.strip():
                    buf.append(line)
                elif buf:
                    yield "\n".join(buf)
                    buf = []
            if buf:
                yield "\n".join(buf)


def pack_tokens(docs: Iterable[str], tokenizer, seq_len: int,
                with_segments: bool = False) -> Iterator:
    """Concatenate tokenized docs with ``eos`` separators; emit
    ``[seq_len]`` int32 rows (the trailing partial row is dropped).
    ``with_segments`` yields ``(tokens, segment_ids)`` with per-row
    local document ids (an eos belongs to the document it ends)."""
    stream: List[int] = []
    seg_stream: List[int] = []
    eos = tokenizer.eos_id
    doc_id = 0
    for doc in docs:
        ids = tokenizer.encode(doc)
        stream.extend(ids)
        stream.append(eos)
        if with_segments:
            seg_stream.extend([doc_id] * (len(ids) + 1))
            doc_id += 1
        while len(stream) >= seq_len:
            row = np.asarray(stream[:seq_len], np.int32)
            del stream[:seq_len]
            if with_segments:
                segs = np.asarray(seg_stream[:seq_len], np.int32)
                del seg_stream[:seq_len]
                yield row, segs - segs[0]
            else:
                yield row


def lm_batches(pattern: str, tokenizer, seq_len: int, batch_size: int, *,
               seed: int = 0, repeat: bool = True, shuffle_buffer: int = 256,
               process_index: int = 0, process_count: int = 1,
               with_segments: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Packed LM batches ``{"input_ids": [B, S] int32}`` (plus
    ``"segment_ids"`` when ``with_segments``). Rows pass through a
    seeded reservoir shuffle buffer; ``repeat`` restarts the file pass
    with the buffer reseeded from ``seed + epoch``."""
    rng = np.random.default_rng(seed)
    epoch = 0
    batch: List = []  # partial batches carry across epochs

    def emit(batch):
        if with_segments:
            return {"input_ids": np.stack([t for t, _ in batch]),
                    "segment_ids": np.stack([s for _, s in batch])}
        return {"input_ids": np.stack(batch)}

    while True:
        buf: List = []
        produced = 0
        rows = pack_tokens(
            iter_documents(pattern, process_index=process_index,
                           process_count=process_count),
            tokenizer, seq_len, with_segments=with_segments)
        for row in rows:
            produced += 1
            if shuffle_buffer > 1:
                buf.append(row)
                if len(buf) < shuffle_buffer:
                    continue
                idx = rng.integers(0, len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                row = buf.pop()
            batch.append(row)
            if len(batch) == batch_size:
                yield emit(batch)
                batch = []
        # index permutation, not rng.shuffle: buf rows may be tuples
        buf = [buf[i] for i in rng.permutation(len(buf))]
        for row in buf:
            batch.append(row)
            if len(batch) == batch_size:
                yield emit(batch)
                batch = []
        if produced == 0:
            # an empty pass would make the trainer spin: fail loudly
            raise ValueError(
                f"{pattern!r} produced no length-{seq_len} rows for "
                f"process {process_index}/{process_count}; corpus too "
                "small or too few files for the host count")
        if not repeat:
            return
        epoch += 1
        rng = np.random.default_rng(seed + epoch)
