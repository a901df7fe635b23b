"""Tokenizers for serving (the port's copy of ``ByteTokenizer`` and
``get_tokenizer`` from ``pyspark_tf_gke_tpu/data/text.py``).

``byte``: UTF-8 bytes 0..255 plus ``<pad>``/``<bos>``/``<eos>`` (vocab
259). The Hugging Face adapter and the LM-pretraining packers are not
ported yet (ROADMAP queue 1, P7 and P8).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence


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


def get_tokenizer(spec: str = "byte") -> ByteTokenizer:
    if spec in ("", "byte"):
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer {spec!r}: only 'byte' is ported; the Hugging Face "
        "adapter is queued in ROADMAP (queue 1, P7)")
