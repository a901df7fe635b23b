"""Masked-language-model example preparation (BERT pretraining recipe;
the port's copy of ``pyspark_tf_gke_tpu/data/mlm.py``).

Host-side, deterministic: 15% of non-special tokens are selected per
row; of those 80% become ``[MASK]``, 10% a uniformly random token, 10%
stay unchanged. Labels carry the original token id at selected
positions and ``IGNORE_INDEX`` elsewhere, so the loss reduces over
masked positions only.

The same numpy generator draws in the same order as the JAX module, so
one seed gives the JAX package's batches bit for bit; the recipe follows
the public BERT objective, training the ``BertForPretraining`` MLM head
(``models/bert.py``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

IGNORE_INDEX = -100

# bert-base-uncased special-token ids (overridable per call)
DEFAULT_MASK_ID = 103   # [MASK]
DEFAULT_SPECIAL_IDS = (0, 101, 102)  # [PAD], [CLS], [SEP]


def apply_mlm_masking(
    input_ids: np.ndarray,           # [B, S] int
    vocab_size: int,
    rng: np.random.Generator,
    mask_prob: float = 0.15,
    mask_token_id: int = DEFAULT_MASK_ID,
    special_ids: Sequence[int] = DEFAULT_SPECIAL_IDS,
    attention_mask: Optional[np.ndarray] = None,  # [B, S] 1=real token
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(masked_ids, labels)``; both [B, S] int32."""
    ids = np.asarray(input_ids)
    candidates = ~np.isin(ids, np.asarray(special_ids))
    if attention_mask is not None:
        candidates &= np.asarray(attention_mask).astype(bool)

    selected = candidates & (rng.random(ids.shape) < mask_prob)
    labels = np.where(selected, ids, IGNORE_INDEX).astype(np.int32)

    action = rng.random(ids.shape)
    masked = ids.copy()
    masked[selected & (action < 0.8)] = mask_token_id
    randomize = selected & (action >= 0.8) & (action < 0.9)
    masked[randomize] = rng.integers(0, vocab_size, int(randomize.sum()))
    # remaining 10%: keep the original token
    return masked.astype(np.int32), labels


def mlm_batches(batches, vocab_size: int, seed: int = 1337,
                mask_prob: float = 0.15,
                mask_token_id: int = DEFAULT_MASK_ID) -> Iterator[Dict[str, np.ndarray]]:
    """Wrap an iterator of {input_ids, attention_mask, ...} batches into
    MLM training batches {input_ids, attention_mask, mlm_labels}."""
    rng = np.random.default_rng(seed)
    for batch in batches:
        masked, labels = apply_mlm_masking(
            batch["input_ids"], vocab_size, rng,
            mask_prob=mask_prob, mask_token_id=mask_token_id,
            attention_mask=batch.get("attention_mask"),
        )
        yield {
            "input_ids": masked,
            "attention_mask": batch.get(
                "attention_mask", np.ones_like(masked)),
            "mlm_labels": labels,
        }
