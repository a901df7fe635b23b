"""Weight-only int8 quantization (the port's copy of the rules in
``pyspark_tf_gke_tpu/ops/quant.py``).

``QTensor`` holds an int8 tensor and a float32 scale: per output column
``(cols,)`` for dense kernels, per row ``(rows, 1)`` for embedding
tables. ``q = clip(round(w / s), -127, 127)`` with ``s = max|w| / 127``
(``torch.round`` rounds half to even, as ``jnp.round`` does).

A model loaded from a quantized tree keeps its ``QTensor`` leaves int8
on the device with their f32 scales (``models/layers.load_flax_params``):
a serving ``Dense`` streams them through K6 (``ops/int8_matmul.py``) at
the JAX package's in-loop sites, and an embedding table gathers int8
rows (:func:`gather_rows`), the counterpart of dequantizing the table
once and gathering (``dequantize_embeddings``).

A parameter tree here is a flat dict keyed by flax path
(``layer_3/attention/query/kernel``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor      # int8, the original kernel's shape
    scale: torch.Tensor  # float32; (cols,) per column or (rows, 1) per row
    dtype: torch.dtype = torch.float32  # restored on dequantize

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)


Params = Dict[str, Union[torch.Tensor, QTensor]]


def is_embedding_path(path: str) -> bool:
    """True when a flax path addresses an embedding table (param name
    ``embedding``) — those get per-row scales."""
    return "embedding" in path.split("/")


def quantize_tensor(w: torch.Tensor, axis: int = -1) -> QTensor:
    """Symmetric int8 with one scale per slice along ``axis`` (-1 =
    per output column, 0 = per row)."""
    wf = w.float()
    axis = axis % wf.dim()
    reduce_dims = tuple(a for a in range(wf.dim()) if a != axis)
    amax = wf.abs().amax(dim=reduce_dims, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    if axis == wf.dim() - 1:
        scale = scale.reshape(-1)
    return QTensor(q, scale, w.dtype)


def quantize_tree(params: Params, min_size: int = 4096) -> Params:
    """Quantize every floating 2-D leaf with ``>= min_size`` elements:
    embedding tables per row, everything else per column."""
    out: Params = {}
    for path, leaf in params.items():
        if (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.numel() >= min_size and leaf.is_floating_point()):
            leaf = quantize_tensor(leaf, axis=0 if is_embedding_path(path)
                                   else -1)
        out[path] = leaf
    return out


def dequantize_tree(params: Params) -> Dict[str, torch.Tensor]:
    return {path: leaf.dequantize() if isinstance(leaf, QTensor) else leaf
            for path, leaf in params.items()}


def is_quantized(params: Params) -> bool:
    return any(isinstance(leaf, QTensor) for leaf in params.values())


def gather_rows(q: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Rows ``ids`` of an int8 table with per-row scales ``[rows, 1]``,
    dequantized and cast to ``dtype``: ``dtype(f32(q[ids]) *
    scale[ids])``, bit for bit what dequantizing the whole table (f32)
    and then gathering and casting gives — no dequantized table is ever
    held."""
    return (q[ids].float() * scale[ids]).to(dtype)


def tree_bytes(params: Params) -> int:
    """Bytes of a (possibly quantized) parameter tree as it sits on the
    device: an int8 leaf counts its int8 elements and f32 scales."""
    total = 0
    for leaf in params.values():
        if isinstance(leaf, QTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total
