"""Loss and metric functions (counterpart of
``pyspark_tf_gke_tpu/train/losses.py``): softmax cross-entropy on
integer labels and accuracy (the classifiers), mean squared error and
mean absolute error (the CNN regressor), all reduced as f32 means over
f32-cast operands whatever the predictions' dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_token_cross_entropy(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels`` in f32:
    ``logits [..., C]``, ``labels [...]`` -> ``[...]``."""
    lg = logits.float()
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    return per_token_cross_entropy(logits, labels).mean()


def accuracy_metric(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    diff = preds.float() - targets.float()
    return torch.mean(diff * diff)


def mae_metric(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds.float() - targets.float()))
