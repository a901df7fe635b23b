"""Chunked large-vocab softmax cross-entropy (counterpart of
``pyspark_tf_gke_tpu/ops/chunked_ce.py``, ``:36-104``).

The dense loss holds f32 logits ``[N, V]`` and their gradient: at
N = 16 x 511 tokens and GPT-2's V = 50257 that is 1.64 GB each. This
loss computes the cross-entropy from the final hidden states and the
LM-head weight one vocab chunk at a time:

* each chunk's logits ``[N, V/C]`` come from one product with f32 sums,
  are folded into an online logsumexp (running max and normalizer) and
  dropped; the label logit and the running argmax ride along, so no
  caller needs the full logits;
* the backward recomputes each chunk's logits from the saved ``hidden``,
  ``kernel``, ``bias``, ``labels`` and ``lse`` (what ``jax.checkpoint``
  of the scan body does): the peak logits memory is ``N * V/C`` in both
  passes.

The JAX contract is kept: ``num_chunks`` is clamped to ``[1, V]``, the
chunk width is ``ceil(V / C)``, padding columns get zero weight and a
``-1e30`` bias, ties in the argmax go to the first index and an earlier
chunk wins a tie (``cav > amax_val``). JAX pads the whole kernel to
``C`` chunks; here each chunk's f32 copy is padded to a multiple of 8
columns (32-byte rows: an odd width sends cuBLAS to slow unaligned
kernels). Padding adds exactly 0 to the normalizer and never wins the
argmax, so the chunk boundaries and the sums are JAX's.

Precision: the operands are promoted as ``jnp.einsum`` promotes them.
Two bf16 (or f16) operands give f32 sums of their products
(``preferred_element_type=float32``), never a half-precision product:
they are upcast to f32 and multiplied with TF32 allowed for that one
product on the card. This is exact: every bf16 and f16 value is a TF32
value, so TF32's products are the half products and its sums are f32.
The backward's logit gradient is rounded to the operand dtype (in
place, in its f32 buffer) before its two products, so they take half
values too. f32 operands give an f32 product without TF32. These
products are cuBLAS calls, as the JAX ones are XLA's: no Pallas kernel
computes them.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

NEG_INF = -1e30

_HALF = (torch.bfloat16, torch.float16)
# chunk storage width multiple: f32 rows of 32 bytes for the tensor cores
_ALIGN = 8


def chunk_bounds(v: int, num_chunks: int) -> List[Tuple[int, int]]:
    """``[start, end)`` of each chunk that holds a real column: the JAX
    chunks of width ``ceil(V / C)`` after clamping ``C`` to ``[1, V]``."""
    num_chunks = max(1, min(num_chunks, v))
    vc = -(-v // num_chunks)
    return [(s, min(s + vc, v)) for s in range(0, v, vc)]


def _operand_dtype(hidden: torch.Tensor, kernel: torch.Tensor) -> torch.dtype:
    dtype = torch.promote_types(hidden.dtype, kernel.dtype)
    return dtype if dtype in _HALF else torch.float32


@contextlib.contextmanager
def _half_products(half: bool, device: torch.device):
    """TF32 products on the card while f32 tensors hold half values
    (exact there); f32 products otherwise."""
    if not (half and device.type == "cuda"):
        yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _chunk(k: torch.Tensor, bias: Optional[torch.Tensor], start: int,
           end: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk's kernel columns as f32 ``[E, Wp]`` and its f32 bias
    ``[Wp]``, ``Wp`` the width rounded up to a multiple of 8: padding
    columns have zero weight and bias ``NEG_INF`` (they add exactly 0 to
    the normalizer, never win the argmax and get no gradient), so every
    product's rows stay 32-byte aligned for the tensor cores."""
    w = end - start
    wp = -(-w // _ALIGN) * _ALIGN
    kc = torch.empty((k.shape[0], wp), dtype=torch.float32, device=k.device)
    kc[:, :w] = k[:, start:end]
    kc[:, w:] = 0.0
    bc = torch.full((wp,), NEG_INF, dtype=torch.float32, device=k.device)
    bc[:w] = 0.0 if bias is None else bias[start:end]
    return kc, bc


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, kernel, bias, labels, num_chunks):
        n = hidden.shape[0]
        dtype = _operand_dtype(hidden, kernel)
        half = dtype in _HALF
        # f32 holders of the operand dtype's values
        h = hidden.to(dtype).float()
        k = kernel.to(dtype)
        labels = labels.long()
        dev = hidden.device
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((n,), dtype=torch.float32, device=dev)
        lbl = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
        amax_val = torch.full((n,), NEG_INF, dtype=torch.float32, device=dev)
        amax_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
        for start, end in chunk_bounds(k.shape[1], num_chunks):
            kc, bc = _chunk(k, bias, start, end)
            with _half_products(half, dev):
                logits = torch.addmm(bc, h, kc)
            local = labels - start
            in_chunk = (local >= 0) & (local < end - start)
            got = logits.gather(1, local.clamp(0, end - start - 1)[:, None])
            lbl = torch.where(in_chunk, got[:, 0], lbl)
            cav, cai = logits.max(dim=-1)
            upd = cav > amax_val
            amax_val = torch.where(upd, cav, amax_val)
            amax_idx = torch.where(upd, cai + start, amax_idx)
            new_m = torch.maximum(m, cav)
            l = l * torch.exp(m - new_m) + logits.sub_(
                new_m[:, None]).exp_().sum(dim=-1)
            m = new_m
            del logits, kc
        lse = m + torch.log(l)
        ctx.num_chunks = num_chunks
        ctx.save_for_backward(hidden, kernel, bias, labels, lse)
        ctx.mark_non_differentiable(amax_idx)
        return lse - lbl, amax_idx.to(torch.int32)

    @staticmethod
    def backward(ctx, g_loss, _g_amax):
        hidden, kernel, bias, labels, lse = ctx.saved_tensors
        dtype = _operand_dtype(hidden, kernel)
        half = dtype in _HALF
        h = hidden.to(dtype).float()
        k = kernel.to(dtype)
        dev = h.device
        need_h, need_k, need_b = ctx.needs_input_grad[:3]
        g = g_loss.float()
        g_h = (torch.zeros(h.shape, dtype=torch.float32, device=dev)
               if need_h else None)
        g_k = (torch.empty(k.shape, dtype=torch.float32, device=dev)
               if need_k else None)
        g_b = (torch.empty(kernel.shape[1], dtype=torch.float32, device=dev)
               if need_b and bias is not None else None)
        for start, end in chunk_bounds(k.shape[1], ctx.num_chunks):
            w = end - start
            kc, bc = _chunk(k, bias, start, end)
            # d loss / d logits = (softmax - onehot(label)) * g, in place
            with _half_products(half, dev):
                dlog = torch.addmm(bc, h, kc)
            dlog.sub_(lse[:, None]).exp_().mul_(g[:, None])
            local = labels - start
            hit = (local >= 0) & (local < w)
            dlog.scatter_add_(1, local.clamp(0, w - 1)[:, None],
                              torch.where(hit, -g, 0.0)[:, None])
            if g_b is not None:
                g_b[start:end] = dlog[:, :w].sum(dim=0)
            if half:  # the products take the gradient at the operand dtype
                dlog.copy_(dlog.to(dtype))
            with _half_products(half, dev):
                if need_h:
                    g_h.addmm_(dlog, kc.t())
                if need_k:
                    g_k[:, start:end] = (h.t() @ dlog)[:, :w]
            del dlog, kc
        return (g_h.to(hidden.dtype) if need_h else None,
                g_k.to(kernel.dtype) if need_k else None,
                g_b.to(bias.dtype) if g_b is not None else None,
                None, None)


def chunked_cross_entropy(hidden: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor], labels: torch.Tensor,
                          num_chunks: int = 8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token softmax cross-entropy of ``hidden [N, E] @ kernel [E, V]
    (+ bias [V])`` against ``labels [N]`` without ``[N, V]`` logits.
    Returns ``(loss [N] float32, argmax [N] int32)``."""
    if hidden.dim() != 2 or kernel.dim() != 2 or (
            hidden.shape[1] != kernel.shape[0]):
        raise ValueError(f"hidden {tuple(hidden.shape)} and kernel "
                         f"{tuple(kernel.shape)} are not [N, E] and [E, V]")
    return _ChunkedCE.apply(hidden, kernel, bias, labels, int(num_chunks))
