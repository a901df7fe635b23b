"""Plain batched attention (counterpart of
``pyspark_tf_gke_tpu/ops/attention.py::dot_product_attention``).

Scores and softmax in f32 whatever the input dtype (f64 for f64 inputs,
as ``gradcheck`` needs); the probabilities
are cast back to the input dtype before the P.V product, as in the JAX
version. A query row with no valid key (every key masked) returns 0,
not the mean of V. Ring and Ulysses attention wait for the parallelism
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def masked_scores(q: torch.Tensor, k: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  causal: bool = False) -> torch.Tensor:
    """f32 (f64 for f64 inputs) scores ``[B, H, Sq, Sk]`` with masked
    entries at NEG_INF. ``mask`` broadcasts to ``[B, H, Sq, Sk]`` (True =
    keep)."""
    scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        scores = torch.where(cm, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    return scores


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False) -> torch.Tensor:
    """``q [B, Sq, H, D]``, ``k/v [B, Sk, H, D]`` -> ``[B, Sq, H, D]``."""
    scores = masked_scores(q, k, mask, causal)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if mask is not None:
        valid = torch.broadcast_to(mask, scores.shape).any(dim=-1)  # [B,H,Sq]
        out = torch.where(valid.transpose(1, 2)[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out
