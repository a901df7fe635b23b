"""Paged attention (K1): ragged block-table reads over a global KV page
pool (counterpart of ``pyspark_tf_gke_tpu/ops/pallas/paged_attention.py``).

The continuous-batching engine keeps K/V in one page pool per layer,
``k_pages [N, P, H_kv, D]``, and each slot owns a row of the block
table ``[num_slots, max_pages]`` naming its pages in order. The
contract is exactly ``paged_attention_chunk_reference`` (``:63-104``):

* ``fills`` counts live tokens INCLUDING the chunk; query ``i`` of an
  ``S``-token chunk sits at ``fill - S + i`` and sees keys at positions
  ``<=`` that (``S = 1`` is the decode step);
* sentinel (``>= N``) table entries are clamped into the pool — whatever
  they read is masked unless it lies under the fill;
* rows with ``fill - S + i < 0`` (incl. empty slots) return zeros;
* GQA: each KV head serves ``H / H_kv`` query heads;
* int8 pages are dequantized with f32 ``[N, P, H_kv]`` scale pages and
  rounded through the query dtype.

One kernel body (``csrc/paged_attention.cu``) serves ``S = 1`` and
``S > 1``: a CTA holds a block of the ``S * H / H_kv`` query rows of a
KV head group, all of them whenever they fit its shared memory
(:func:`row_plan`), so any ``S`` launches. The wrappers take the plain
version only for CPU tensors; a CUDA tensor launches the kernel or
raises. Paged attention has no backward (neither has the JAX kernel):
under grad mode, an input that requires a gradient makes the wrappers
raise, on every device, instead of returning a result that autograd
would not track.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

NEG_INF = -1e30
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_ROW_BLOCKS = 65535  # the grid's z dimension: row blocks of a group

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def paged_attention_chunk_plain(q, k_pages, v_pages, block_table, fills,
                                k_scales=None, v_scales=None):
    """Plain PyTorch: gather every table page densely, mask causally per
    query, softmax in f32. ``q [B, S, H, D]`` -> ``[B, S, H, D]``."""
    n, p_sz, hkv, d = k_pages.shape
    b, s, h, _ = q.shape
    mp = block_table.shape[1]
    g = h // hkv
    safe = block_table.long().clamp(0, n - 1)
    k = k_pages[safe].reshape(b, mp * p_sz, hkv, d)
    v = v_pages[safe].reshape(b, mp * p_sz, hkv, d)
    if k_scales is not None:
        ks = k_scales[safe].reshape(b, mp * p_sz, hkv)
        vs = v_scales[safe].reshape(b, mp * p_sz, hkv)
        k = (k.float() * ks[..., None]).to(q.dtype)
        v = (v.float() * vs[..., None]).to(q.dtype)
    q5 = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(),
                          k.float()) * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    q_abs = fills.long()[:, None] - s + pos[None, :]                 # [B, S]
    k_pos = torch.arange(mp * p_sz, device=q.device)
    valid = k_pos[None, None, :] <= q_abs[:, :, None]                # [B, S, K]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    out = out.reshape(b, s, h, d)
    keep = (q_abs >= 0)[:, :, None, None]
    return torch.where(keep, out, torch.zeros((), dtype=q.dtype,
                                              device=q.device))


def refuse_grad(*tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would need a backward of paged attention."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "paged attention has no backward: call it under torch.no_grad()"
            " or torch.inference_mode(), on inputs that need no gradient")


def smem_bytes(rows: int, d: int, p: int) -> int:
    """Shared memory of a K1 CTA holding ``rows`` query rows (the figure
    of ``csrc/paged_attention.cu`` ``smem_bytes``): a page of K (rows
    padded to D + 1) and V, and per row its query, scores, accumulator
    and three softmax scalars, all f32."""
    return 4 * (p * (d + 1) + p * d + rows * d + rows * p + rows * d
                + 3 * rows)


def row_plan(s: int, h: int, hkv: int, d: int, p: int) -> Tuple[int, int,
                                                                  int]:
    """K1's split of a KV head group's ``R = S * H / H_kv`` query rows
    over CTAs: ``(rows per CTA, row blocks, shared-memory bytes)``. All R
    rows in one CTA when they fit :data:`MAX_SMEM` (every decode step and
    verify chunk), else the fewest equal blocks that fit. A function of
    the shape alone. Raises ``ValueError`` only where the grid cannot
    express the split: a page of K and V leaves no room for one row, or
    more than :data:`MAX_ROW_BLOCKS` blocks."""
    r = s * (h // hkv)
    fixed = smem_bytes(0, d, p)
    most = (MAX_SMEM - fixed) // (smem_bytes(1, d, p) - fixed)
    if most < 1:
        raise ValueError(f"paged kernel: a page of P={p}, D={d} needs "
                         f"{smem_bytes(1, d, p)} bytes of shared memory for "
                         f"one query row (max {MAX_SMEM})")
    rows = -(-r // -(-r // most))  # the fewest blocks, equal to a row
    blocks = -(-r // rows)         # as the kernel counts them
    if blocks > MAX_ROW_BLOCKS:
        raise ValueError(f"paged kernel: {r} query rows need {blocks} row "
                         f"blocks (max {MAX_ROW_BLOCKS})")
    return rows, blocks, smem_bytes(rows, d, p)


def _launch(q, k_pages, v_pages, block_table, fills, k_scales, v_scales):
    global launches
    quant = k_scales is not None
    extra = (k_scales, v_scales) if quant else ()
    device = kernels.require_cuda("paged_attention", q, k_pages, v_pages,
                                  block_table, fills, *extra)
    b, s, h, d = q.shape
    n, p_sz, hkv, dk = k_pages.shape
    mp = block_table.shape[1]
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pages must be [N, P, H_kv, {d}] for K and V, got "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if block_table.shape != (b, mp) or fills.shape != (b,):
        raise ValueError("block_table must be [B, max_pages] and fills [B]")
    if block_table.dtype != torch.int32 or fills.dtype != torch.int32:
        raise TypeError("block_table and fills must be int32")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k_pages and v_pages must share one dtype")
    qcode = kernels.dtype_code(q.dtype, "paged_attention")
    kvcode = kernels.dtype_code(k_pages.dtype, "paged_attention")
    if quant:
        if k_pages.dtype != torch.int8:
            raise TypeError("scale pages come with int8 K/V pages")
        for sc in (k_scales, v_scales):
            if sc.shape != (n, p_sz, hkv) or sc.dtype != torch.float32:
                raise ValueError("scale pages must be float32 [N, P, H_kv]")
    elif k_pages.dtype != q.dtype:
        raise TypeError(f"pages of {k_pages.dtype} need scale pages or a "
                        f"{k_pages.dtype} query (got {q.dtype})")
    if qcode == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError("paged kernel takes a float query")
    tensors = (q, k_pages, v_pages, block_table, fills) + extra
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged kernel takes contiguous tensors")
    rows = row_plan(s, h, hkv, d, p_sz)[0]
    if hkv > 65535:
        raise ValueError("paged kernel grid takes H_kv <= 65535")
    out = torch.empty_like(q)
    lib = kernels.library()
    rc = lib.port_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_table.data_ptr(), fills.data_ptr(), out.data_ptr(),
        b, s, h, hkv, d, n, p_sz, mp, rows, float(d ** -0.5), qcode, kvcode,
        *kernels.launch_args(device))
    kernels.check(rc, "paged_attention")
    launches += 1
    return out


def paged_attention_chunk(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          fills: torch.Tensor,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Multi-query chunk attention through a block table. ``q [B, S, H,
    D]``; ``fills [B]`` int32 live tokens including the chunk. Returns
    ``[B, S, H, D]``."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    refuse_grad(q, k_pages, v_pages, k_scales, v_scales)
    h, hkv = q.shape[2], k_pages.shape[2]
    if h % hkv:
        raise ValueError(f"num_kv_heads {hkv} must divide num_heads {h}")
    if q.device.type == "cpu":
        return paged_attention_chunk_plain(q, k_pages, v_pages, block_table,
                                           fills, k_scales, v_scales)
    return _launch(q, k_pages, v_pages, block_table, fills, k_scales,
                   v_scales)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    fills: torch.Tensor,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention, one query token per slot: ``q [B, H, D]`` ->
    ``[B, H, D]`` (the ``S = 1`` chunk; ``fills`` includes the token
    just written, 0 = empty slot -> zeros)."""
    return paged_attention_chunk(q[:, None], k_pages, v_pages, block_table,
                                 fills, k_scales, v_scales)[:, 0]
