"""Token embedding (counterpart of
``pyspark_tf_gke_tpu/models/embedding.py::TokenEmbed``).

Same parameter name (``embedding``) and ``[num_embeddings, features]``
shape. The lookup gathers rows of the table and casts them to the
compute dtype. Serving (``param_dtype=None``) holds the table in the
compute dtype, where the cast is a no-op, or, loaded from an int8 tree,
keeps it int8 with its per-row f32 scales and gathers int8 rows
(``ops/quant.gather_rows``: bit for bit the JAX package's dequantize-
then-gather, ``dequantize_embeddings``). Training
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

from pyspark_tf_gke_tpu_torch.ops.quant import QTensor, gather_rows


class TokenEmbed(nn.Module):
    spmd = None  # set by the trainer on a mesh (parallel/spmd.py)

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 axes: Optional[tuple] = None):
        super().__init__()
        self.dtype = dtype
        self.logical_axes = {"embedding": axes} if axes else None
        self.rows = num_embeddings
        trainable = param_dtype is not None
        self.embedding = nn.Parameter(
            torch.zeros(num_embeddings, features,
                        dtype=param_dtype if trainable else dtype),
            requires_grad=trainable)
        self.register_buffer("embedding_scale", None)

    def hold_int8(self, qt: QTensor) -> None:
        """Keep ``qt`` as the table: int8 rows and their f32 scales
        ``[rows, 1]``, on the table's device (serving only)."""
        if self.embedding.requires_grad:
            raise ValueError("a trainable TokenEmbed holds a float table")
        rows = self.embedding.shape[0]
        if tuple(qt.q.shape) != tuple(self.embedding.shape) or (
                qt.scale.numel() != rows):
            raise ValueError(f"int8 table {tuple(qt.q.shape)} with scales "
                             f"{tuple(qt.scale.shape)} does not fit "
                             f"{tuple(self.embedding.shape)} per row")
        device = self.embedding.device
        self.embedding = nn.Parameter(qt.q.to(device, torch.int8),
                                      requires_grad=False)
        self.embedding_scale = qt.scale.to(device, torch.float32).reshape(
            rows, 1)

    def _rows(self, ids: torch.Tensor) -> torch.Tensor:
        if self.embedding_scale is not None:
            return gather_rows(self.embedding, self.embedding_scale, ids,
                               self.dtype)
        return self.embedding[ids]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = self.embedding.shape[0]
        if local != self.rows:
            # vocab-parallel: this tp rank holds rows [r*local, (r+1)*local)
            # (int8 rows with their scales); the others' rows come in
            # through the sum
            tp = self.spmd.tp
            idx = ids - tp.rank * local
            mine = (idx >= 0) & (idx < local)
            rows = self._rows(torch.where(mine, idx, 0))
            rows = torch.where(mine[..., None], rows, 0.0)
            return tp.reduce_from(rows).to(self.dtype)
        return self._rows(ids).to(self.dtype)
