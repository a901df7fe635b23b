"""Token embedding (counterpart of
``pyspark_tf_gke_tpu/models/embedding.py::TokenEmbed``).

Same parameter name (``embedding``) and ``[num_embeddings, features]``
shape. The lookup gathers rows of the table and casts them to the
compute dtype. Serving (``param_dtype=None``) holds the table in the
compute dtype, where the cast is a no-op. Training
(``param_dtype=torch.float32``) holds a trainable f32 table, as the JAX
module does; gathering from the f32 table and then casting gives the
same forward as the JAX one-hot matmul (bit-exact, a 0/1 contraction),
and its backward scatters the gradient rows into an f32 gradient, so
the table's gradient accumulates in f32 as the one-hot matmul's does.
The one-hot form itself exists in the JAX package for GSPMD's sake and
is not needed here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class TokenEmbed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        trainable = param_dtype is not None
        self.embedding = nn.Parameter(
            torch.zeros(num_embeddings, features,
                        dtype=param_dtype if trainable else dtype),
            requires_grad=trainable)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.dtype)
