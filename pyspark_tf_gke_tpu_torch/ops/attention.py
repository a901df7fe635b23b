"""Attention ops (counterpart of ``pyspark_tf_gke_tpu/ops/attention.py``).

* :func:`dot_product_attention` — plain batched attention. Scores and
  softmax in f32 whatever the input dtype (f64 for f64 inputs, as
  ``gradcheck`` needs); the probabilities are cast back to the input
  dtype before the P.V product, as in the JAX version. A query row with
  no valid key (every key masked) returns 0, not the mean of V.
* :func:`ring_attention` — sequence-parallel attention over a
  ``torch.distributed`` process group (the sp group; JAX: the ``sp``
  mesh axis). Each rank holds one sequence block of Q/K/V and of the key
  mask; the K/V blocks rotate around the ring (rank ``r`` sends to
  ``r+1`` and receives from ``r-1``; in the backward the cotangents ride
  the reversed ring) and the partial results combine online, so no rank
  ever holds the whole sequence. Two block engines: the dense
  online-softmax block (:func:`_ring_block`, causal or not, global
  positions for the causal mask) and the flash block
  (:func:`_ring_block_flash`: ``flash_attention_block`` per ring step,
  merged by logsumexp; non-causal only, as in the JAX package, whose
  kernel masks causally within a block).
* :func:`ulysses_attention` — the all-to-all alternative: one
  all-to-all swaps the sequence split for a head split, attention runs
  locally over the whole sequence for ``H / sp`` heads (the flash kernel
  or the dense path, causal allowed), and the inverse all-to-all
  restores the sequence split. The heads must divide by the group size.

A group of one rank (or none) runs :func:`dot_product_attention`. On
the card ``use_flash=None`` means the kernel (the ring's non-causal
block, Ulysses' local attention); the JAX package's ``FLASH_MIN_SEQ``
is a TPU crossover and does not carry over. The transport is whatever
backend the group has: gloo on the CPU (the tests' worlds of 2 and 4),
NCCL across cards.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

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


# -- sequence parallelism -------------------------------------------------------


def sp_world(group) -> int:
    """Ranks in the sp ``group``: 1 without one (or without
    ``torch.distributed``)."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _ring_pass(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to group rank ``rank + shift`` and return what rank
    ``rank - shift`` sent (both mod the group size)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    dst = dist.get_global_rank(group, (rank + shift) % size)
    src = dist.get_global_rank(group, (rank - shift) % size)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, dst, group),
            dist.P2POp(dist.irecv, out, src, group)]):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One step around the ring (``lax.ppermute`` with ``j -> j+1``);
    the cotangent goes one step back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring_pass(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring_pass(g, ctx.group, -1), None


def _rotate_kv(k: torch.Tensor, v: torch.Tensor, group):
    """K and V one step around the ring as one message (one exchange a
    step, forward and backward)."""
    kv = _RingShift.apply(torch.stack((k, v)), group)
    return kv[0], kv[1]


def _rotate_mask(mask: torch.Tensor, group) -> torch.Tensor:
    # bool travels as bytes (not every backend sends bool)
    return _ring_pass(mask.to(torch.uint8), group, 1).bool()


def _ring_kv(k, v, kv_mask, group):
    """The K/V blocks (and key masks) this rank holds around the ring:
    its own, then after ``i`` rotations the block of ``rank - i``. The
    last rotation would only bring k/v home, so it is not made."""
    size = dist.get_world_size(group)
    for i in range(size):
        yield k, v, kv_mask
        if i + 1 < size:
            k, v = _rotate_kv(k, v, group)
            if kv_mask is not None:
                kv_mask = _rotate_mask(kv_mask, group)


def _ring_block(q, k, v, kv_mask, group, causal: bool) -> torch.Tensor:
    """The dense online-softmax engine: the local Q block attends to
    every K/V block as they rotate (``_ring_block`` of the JAX
    package), causally by global positions when asked."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.to(acc)
    o = torch.zeros((b, sq, h, d), dtype=acc, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=acc, device=q.device)
    l = torch.zeros((b, h, sq), dtype=acc, device=q.device)
    for i, (k, v, kv_mask) in enumerate(_ring_kv(k, v, kv_mask, group)):
        # after i rotations this rank holds the block of rank - i
        src = (rank - i) % size
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(acc)) * scale
        if causal:
            q_pos = rank * sq + torch.arange(sq, device=q.device)
            k_pos = src * sk + torch.arange(sk, device=q.device)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None],
                            s, NEG_INF)
        if kv_mask is not None:
            s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)))
        m = m_new
    # rows with no valid key anywhere keep m == NEG_INF: their p/l
    # accumulations are exp(0) = 1 garbage, zeroed here
    valid = (m > NEG_INF / 2).transpose(1, 2)[..., None]
    l = torch.where(l == 0.0, 1.0, l)
    out = o / l.transpose(1, 2)[..., None]
    return torch.where(valid, out, 0.0).to(q.dtype)


def _merge_partial(o, lse, o_i, lse_i):
    """Combine two partial attentions (outputs + logsumexps ``[B, S,
    H]``) over disjoint key sets — the flash-style merge. NEG_INF (not
    -inf) marks empty rows, so the -inf minus -inf NaN never arises;
    merged empty rows are 0*w + 0*w = 0."""
    lse_new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - lse_new)[..., None]
    w_i = torch.exp(lse_i - lse_new)[..., None]
    return o * w + o_i.to(o.dtype) * w_i, lse_new


def flash_block_merge(q, kv_blocks) -> torch.Tensor:
    """Attention of ``q`` over disjoint key blocks: each ``(k, v,
    kv_mask)`` of ``kv_blocks`` through ``flash_attention_block`` (K2f
    on the card), the partial results merged by logsumexp in f32 (or
    wider). The ring's flash engine, with the blocks it receives."""
    from pyspark_tf_gke_tpu_torch.ops.flash_attention import (
        flash_attention_block)

    acc = torch.promote_types(q.dtype, torch.float32)
    b, sq, h, d = q.shape
    o = torch.zeros((b, sq, h, d), dtype=acc, device=q.device)
    lse = torch.full((b, sq, h), NEG_INF, dtype=acc, device=q.device)
    for k, v, kv_mask in kv_blocks:
        o_i, lse_i = flash_attention_block(q, k, v, kv_mask=kv_mask)
        o, lse = _merge_partial(o, lse, o_i, lse_i.to(acc))
    return o.to(q.dtype)


def _ring_block_flash(q, k, v, kv_mask, group) -> torch.Tensor:
    """The flash engine: the block entry on the resident K/V block each
    ring step, merged by logsumexp."""
    return flash_block_merge(q, _ring_kv(k, v, kv_mask, group))


def _local_mask(kv_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if kv_mask is None else kv_mask.bool().contiguous()


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, kv_mask: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Sequence-parallel attention over the process group ``group``.

    ``q/k/v [B, S_local, H, D]`` and ``kv_mask [B, S_local]`` are this
    rank's sequence block (rank ``r`` holds positions ``r * S_local`` to
    ``(r + 1) * S_local - 1``); returns this rank's output block.
    ``use_flash`` picks the block engine: the flash block (None = on the
    card, non-causal), else the dense online-softmax block. Causal ring
    flash raises."""
    size = sp_world(group)
    mask = _local_mask(kv_mask)
    if size == 1:
        return dot_product_attention(
            q, k, v, mask=None if mask is None else mask[:, None, None, :],
            causal=causal)
    if use_flash is None:
        use_flash = not causal and q.device.type == "cuda"
    if use_flash:
        if causal:
            raise ValueError("ring flash attention does not support "
                             "causal=True")
        return _ring_block_flash(q, k, v, mask, group)
    return _ring_block(q, k, v, mask, group, causal)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # both buffers contiguous: the collective reads and writes dim-0
    # chunks as flat memory (a cotangent may arrive permuted)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all_single`` over dim 0 in equal splits: chunk
    ``j`` goes to rank ``j``, the chunk from rank ``j`` lands at ``j``.
    Its own inverse, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _seq_to_heads(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[B, S/sp, H, D]`` -> ``[B, S, H/sp, D]``: split the heads,
    gather the sequence (``lax.all_to_all(split_axis=2, concat_axis=1,
    tiled=True)``)."""
    b, sl, h, d = x.shape
    parts = x.reshape(b, sl, size, h // size, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(parts.contiguous(), group)  # [src, B, Sl, h, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, size * sl, h // size, d)


def _heads_to_seq(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The inverse: ``[B, S, H/sp, D]`` -> ``[B, S/sp, H, D]``."""
    b, s, hl, d = x.shape
    parts = x.reshape(b, size, s // size, hl, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(parts.contiguous(), group)  # [src, B, Sl, hl, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // size, size * hl, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, kv_mask: Optional[torch.Tensor] = None,
                      causal: bool = False,
                      use_flash: Optional[bool] = None) -> torch.Tensor:
    """All-to-all sequence parallelism over the process group ``group``:
    ``q/k/v [B, S_local, H, D]`` and ``kv_mask [B, S_local]`` are this
    rank's sequence block, and the output is too. The local attention
    sees the whole sequence, so ``causal`` works with either engine;
    ``use_flash`` (None = on the card) runs it through the flash
    kernel. ``H`` must divide by the group size."""
    from pyspark_tf_gke_tpu_torch.ops.flash_attention import flash_attention

    size = sp_world(group)
    if use_flash is None:
        use_flash = q.device.type == "cuda"
    mask = _local_mask(kv_mask)

    def attend(q, k, v, mask):
        if use_flash:
            return flash_attention(q, k, v, kv_mask=mask, causal=causal)
        return dot_product_attention(
            q, k, v, mask=None if mask is None else mask[:, None, None, :],
            causal=causal)

    if size == 1:
        return attend(q, k, v, mask)
    heads = q.shape[2]
    if heads % size:
        raise ValueError(
            f"ulysses needs a head count {heads} divisible by the sp group "
            f"size {size}; use ring_attention instead")
    q, k, v = (_seq_to_heads(t, group, size) for t in (q, k, v))
    full_mask = None
    if mask is not None:
        parts = [torch.empty_like(mask, dtype=torch.uint8)
                 for _ in range(size)]
        dist.all_gather(parts, mask.to(torch.uint8), group=group)
        full_mask = torch.cat(parts, dim=1).bool().contiguous()
    return _heads_to_seq(attend(q, k, v, full_mask), group, size)
