"""Scoring for ``/v1/score`` (counterpart of
``pyspark_tf_gke_tpu/train/serving.py::_nll_kernel`` / ``serve_score``):
one full causal forward, then the masked per-row total next-token NLL
as plain f32 cross-entropy. The multi-host announce/replay wire is not
ported (ROADMAP queue 1, P11)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM


@torch.inference_mode()
def serve_score(model: CausalLM, ids, lengths) -> np.ndarray:
    """Per-row total NLL (nats) of ``ids [B, S]``; position ``j`` scores
    token ``j + 1`` while ``j + 1 < lengths[row]``."""
    device = model.device
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.long,
                              device=device)
    logits = model(ids)
    lg = logits[:, :-1].float()
    per_tok = F.cross_entropy(lg.transpose(1, 2), ids[:, 1:],
                              reduction="none")
    mask = (torch.arange(ids.shape[1] - 1, device=device)[None, :]
            < (lengths - 1)[:, None])
    return (per_tok * mask).sum(dim=1).cpu().numpy()
