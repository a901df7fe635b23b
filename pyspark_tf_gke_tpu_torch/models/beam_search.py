"""Beam-search decoding over the dense KV cache (the counterpart of
``pyspark_tf_gke_tpu/models/beam_search.py``).

* The prompt is prefilled ONCE at batch ``B`` (one causal forward: K2f
  and K3 on CUDA) and the per-layer cache is tiled to ``B*K``
  (``repeat_interleave``).
* Each step feeds every beam's last token at its sequence position (a
  dense-cache decode forward), scores ``[B*K, V]`` continuations,
  flattens each batch row to ``[B, K*V]``, takes the top K, and reorders
  the cache and the token history over the beam axis (``index_select``
  on the ``[B*K, ...]`` tensors: the JAX package's gather variant).
* Hypotheses that emit eos move into a FINISHED pool of K
  length-penalised entries (GNMT-style); active beams never carry eos,
  and pruning and final selection use the same penalised score
  ``score / ((5+len)/6)**alpha``.

Top-k picks use a stable descending sort, so ties resolve to the lower
index as ``jax.lax.top_k`` resolves them. The loop is eager: one decode
forward and one cache reorder a new token.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM, DenseCache

NEG_INF = -1e30


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest along the last axis, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _tile_beams(cache: DenseCache, k: int) -> None:
    """``[B, ...] -> [B*K, ...]`` in place, each row repeated K times."""
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if leaves is None:
            continue
        for i, leaf in enumerate(leaves):
            leaves[i] = leaf.repeat_interleave(k, dim=0)


def _beam_rows(beam_idx: torch.Tensor) -> torch.Tensor:
    """Flat ``[B*K]`` source rows of ``beam_idx [B, K]`` (source beam
    indices within each batch row)."""
    b, k = beam_idx.shape
    base = torch.arange(b, device=beam_idx.device)[:, None] * k
    return (base + beam_idx).reshape(-1)


def _reorder_beams(cache: DenseCache, rows: torch.Tensor) -> None:
    """Gather every cache leaf's ``[B*K, ...]`` rows (in place)."""
    for leaves in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if leaves is None:
            continue
        for i, leaf in enumerate(leaves):
            leaves[i] = leaf.index_select(0, rows)


def _penalty(length, alpha: float):
    if isinstance(length, torch.Tensor):
        return ((5.0 + length.float()) / 6.0) ** alpha
    return ((5.0 + float(length)) / 6.0) ** alpha


def _merge_finished(fin_scores, fin_tokens, new_scores, new_tokens, k: int):
    """Keep the K best of pool and new candidates (both penalised)."""
    all_scores = torch.cat([fin_scores, new_scores], dim=1)
    all_tokens = torch.cat([fin_tokens, new_tokens], dim=1)
    fin_scores, idx = _topk(all_scores, k)
    fin_tokens = torch.gather(
        all_tokens, 1, idx[:, :, None].expand(-1, -1, all_tokens.shape[2]))
    return fin_scores, fin_tokens


def _beam_decode(model: CausalLM, cache: DenseCache,
                 last_logits: torch.Tensor, *, max_new_tokens: int,
                 num_beams: int, eos_token_id: Optional[int], s_prompt: int,
                 length_penalty: float):
    device = last_logits.device
    b, v = last_logits.shape
    k = num_beams
    t_max = max_new_tokens

    _tile_beams(cache, k)                                   # [B*K, ...]
    logp0 = torch.log_softmax(last_logits.float(), dim=-1)  # [B, V]

    fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                            device=device)
    fin_tokens = torch.zeros((b, k, t_max), dtype=torch.long, device=device)
    if eos_token_id is not None:
        # seed the pool with the "ends immediately" hypothesis
        fin_scores[:, 0] = logp0[:, eos_token_id] / _penalty(1,
                                                             length_penalty)
        fin_tokens[:, 0, 0] = eos_token_id
        logp0 = logp0.clone()
        logp0[:, eos_token_id] = NEG_INF

    scores, tok0 = _topk(logp0, k)                          # [B, K]
    tokens = torch.zeros((b * k, t_max), dtype=torch.long, device=device)
    tokens[:, 0] = tok0.reshape(-1)

    for t in range(s_prompt, s_prompt + t_max - 1):
        # the last emitted token of each beam sits at history position
        # pos = t - s_prompt and is fed at sequence position t
        pos = t - s_prompt
        logits = model(tokens[:, pos:pos + 1],
                       positions=torch.full((b * k, 1), t, device=device),
                       cache=cache, inloop=True)[:, 0]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        if eos_token_id is not None:
            # hypotheses finishing NOW: length pos + 2 (eos included)
            end_scores = ((scores + logp[:, :, eos_token_id])
                          / _penalty(pos + 2, length_penalty))
            end_tokens = tokens.reshape(b, k, t_max).clone()
            end_tokens[:, :, pos + 1] = eos_token_id
            fin_scores, fin_tokens = _merge_finished(
                fin_scores, fin_tokens, end_scores, end_tokens, k)
            logp[:, :, eos_token_id] = NEG_INF
        cand = scores.reshape(b, k, 1) + logp                   # [B, K, V]
        scores, flat_idx = _topk(cand.reshape(b, k * v), k)
        beam_idx = flat_idx // v                                # [B, K]
        new_tok = flat_idx % v                                  # [B, K]
        rows = _beam_rows(beam_idx)
        _reorder_beams(cache, rows)
        tokens = tokens.index_select(0, rows)
        tokens[:, pos + 1] = new_tok.reshape(-1)

    # still-active beams compete at full length against the finished
    # pool, under the same penalty
    active_final = scores / _penalty(t_max, length_penalty)
    fin_scores, fin_tokens = _merge_finished(
        fin_scores, fin_tokens, active_final, tokens.reshape(b, k, t_max), k)
    best_tokens = fin_tokens[:, 0]                              # [B, T]
    best_scores = fin_scores[:, 0]
    if eos_token_id is not None:
        # everything after the first eos becomes eos
        seen = torch.cumsum((best_tokens == eos_token_id).long(), dim=1) > 0
        shifted = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                         device=device), seen[:, :-1]], dim=1)
        best_tokens = torch.where(shifted, eos_token_id, best_tokens)
    return best_tokens, best_scores


@torch.inference_mode()
def beam_search(model: CausalLM, prompt_ids, max_new_tokens: int,
                num_beams: int = 4, eos_token_id: Optional[int] = None,
                length_penalty: float = 1.0):
    """Returns ``(sequences [B, S_prompt+max_new_tokens], scores [B])``:
    the best beam of each row with its length-normalised
    log-probability. With ``eos_token_id=None``, ``num_beams=1`` is
    greedy ``generate``."""
    cfg = model.cfg
    device = model.device
    if not isinstance(prompt_ids, torch.Tensor):
        prompt_ids = torch.from_numpy(np.asarray(prompt_ids))
    prompt = prompt_ids.to(device=device, dtype=torch.long)
    b, s_prompt = prompt.shape
    if s_prompt + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {s_prompt} + {max_new_tokens} new tokens exceeds "
            f"max_seq_len {cfg.max_seq_len}")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if not 1 <= num_beams < cfg.vocab_size:
        raise ValueError(
            f"num_beams must be in [1, vocab_size); got {num_beams} "
            f"(vocab {cfg.vocab_size})")
    if eos_token_id is not None and not 0 <= eos_token_id < cfg.vocab_size:
        raise ValueError(
            f"eos_token_id {eos_token_id} outside vocab [0, {cfg.vocab_size})")
    cache = DenseCache(cfg, b, cfg.max_seq_len, device, model.kv_cache_heads)
    last_logits = model(prompt, cache=cache, prefill=True,
                        last_index=torch.full((b,), s_prompt - 1,
                                              device=device))[:, 0]
    best_tokens, scores = _beam_decode(
        model, cache, last_logits, max_new_tokens=max_new_tokens,
        num_beams=num_beams, eos_token_id=eos_token_id, s_prompt=s_prompt,
        length_penalty=length_penalty)
    return torch.cat([prompt, best_tokens], dim=1), scores

