"""Token embedding (counterpart of
``pyspark_tf_gke_tpu/models/embedding.py::TokenEmbed``).

Same parameter name (``embedding``) and ``[num_embeddings, features]``
shape. The port serves only, so the lookup is a plain gather; the
one-hot matmul the JAX package uses for its training backward is not
needed. The table is held in the compute dtype: a gather followed by a
cast and a cast followed by a gather give the same numbers.
"""

from __future__ import annotations

import torch
from torch import nn


class TokenEmbed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.zeros(num_embeddings, features, dtype=dtype),
            requires_grad=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]
