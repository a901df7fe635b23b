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

The kernel (``csrc/paged_attention.cu``) has three variants, and
:func:`paged_plan` picks one and its launch shape from the shapes and
dtypes alone (never from ``fills``, never from the card): ``decode``, a
split-KV design for every decode step and the narrowest verify chunks
(``S <= 4``; f32 chunks up to ``S = 8``); ``chunk``, a tensor-core
design for wider chunks with a bf16 query (speculative verify chunks
from ``S = 5``, the 256-token chunked-prefill piece); and ``rows``, the
first design, for wider f32 chunks and shapes the others do not take
(head_dim other than 64 and 128, pages not a multiple of 16 tokens).
Any ``S``
launches. The
wrappers take the plain
version only for CPU tensors; a CUDA tensor launches the kernel or
raises. Paged attention has no backward (neither has the JAX kernel):
under grad mode, an input that requires a gradient makes the wrappers
raise, on every device, instead of returning a result that autograd
would not track.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

NEG_INF = -1e30
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper
MAX_ROW_BLOCKS = 65535  # the grid's z dimension: row blocks of a group

# The decode variant: 128-thread CTAs of four warps, 1-8 query rows a
# CTA, head_dim 64 or 128, key groups of 16 tokens; a split walks
# ``pages_per_split`` table entries, each warp through a ring of at most
# DECODE_MAX_STAGES cp.async slots, the slots of a CTA within
# DECODE_RING_BYTES. Splits are sized so that ``B * H_kv * splits *
# row blocks`` reaches DECODE_TARGET_CTAS (a constant: the plan never
# asks the card); at 8 slots x 12 KV heads x 16 pages that is 4 splits
# of 4 pages, the fastest split measured there (kernel_probe.py
# paged-modes, PERF.md). Every chunk of S <= DECODE_MAX_S takes the
# decode variant; a wider one the chunk variant where it takes the shape
# (at the serving decode shape it was faster from S = 5: 0.0200 against
# 0.0204 ms at fills {0..1024} and 0.0159 against 0.0234 at 716 each;
# 2.2x faster at S = 16), else the decode variant up to
# DECODE_ALONE_MAX_S (f32 chunks, which the chunk variant does not
# take), else the first design.
DECODE_ROWS = (1, 2, 4, 8)
DECODE_DS = (64, 128)  # head widths the decode and chunk variants take
DECODE_KEYS = 16
DECODE_WARPS = 4
DECODE_MAX_STAGES = 4
DECODE_RING_BYTES = 64 * 1024
DECODE_TARGET_CTAS = 384
DECODE_MAX_S = 4
DECODE_ALONE_MAX_S = 8
# The chunk variant: 128 query rows a CTA, 64-token pages, head_dim 64
# or 128, a bf16 query; two K/V slots and a 128-row Q tile, 1024-byte
# aligned.
CHUNK_ROWS = 128
VARIANTS = {"rows": 0, "decode": 1, "chunk": 2}  # csrc enum Variant


def chunk_smem(d: int) -> int:
    """Shared memory of a chunk CTA at head_dim ``d``: 1024 bytes of
    alignment slack, the bf16 Q tile and two K/V page slots."""
    return 1024 + CHUNK_ROWS * 2 * d + 2 * 2 * 64 * 2 * d


def part_stride(d: int) -> int:
    """A decode split's partial row: acc[d], m, l (f32)."""
    return d + 2

launches = 0  # kernel launches since the last reset (chip_smoke reads it)
# launches by variant since the last reset: which one a path took
variant_launches = {name: 0 for name in VARIANTS}


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


class PagedPlan(NamedTuple):
    """K1's variant and launch shape for one call."""
    variant: str  # "decode", "chunk" or "rows" (the first design)
    rows: int  # query rows a CTA holds
    blocks: int  # row blocks of a head group's R rows
    splits: int  # decode: CTAs along the table; otherwise 1
    pages_per_split: int  # decode: table entries a split walks; else MP
    stages: int  # decode: cp.async slots a warp; chunk 2; rows 1
    smem: int  # dynamic shared memory of a CTA, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _decode_slots(kv_size: int, d: int) -> int:
    """Bytes of one ring slot of each of a decode CTA's warps: a key
    group's K and V rows of head_dim ``d``, and for int8 pages their 16
    + 16 scales."""
    return DECODE_WARPS * (2 * DECODE_KEYS * d * kv_size
                           + (2 * DECODE_KEYS * 4 if kv_size == 1 else 0))


def decode_smem(rows: int, stages: int, kv_size: int, d: int) -> int:
    """Shared memory of a decode CTA (``csrc/paged_attention.cu``
    ``dec::smem_bytes``): its f32 query rows, then the four warps' rings
    of K and V key groups (and int8 scales), which the warps' final
    states (m, l and d sums a row) reuse."""
    ring = stages * _decode_slots(kv_size, d)
    merge = 4 * DECODE_WARPS * rows * part_stride(d)
    return 4 * rows * d + max(ring, merge)


def paged_plan(b: int, s: int, h: int, hkv: int, d: int, p: int, mp: int,
               qdtype: torch.dtype, kvdtype: torch.dtype,
               pages_per_split: Optional[int] = None,
               variant: Optional[str] = None) -> PagedPlan:
    """K1's variant and launch shape for ``b`` slots of ``s`` queries,
    ``h`` heads over ``hkv`` KV heads of width ``d``, pages of ``p``
    tokens, ``mp`` table entries a slot — a function of the shape and
    dtypes alone. ``decode`` for ``s <= DECODE_MAX_S`` (head_dim 64 or
    128, pages a multiple of 16 tokens); else ``chunk`` for a bf16 query
    over 64-token pages of head_dim 64 or 128; else ``decode`` up to
    ``DECODE_ALONE_MAX_S``; else the first design
    (:func:`row_plan`). ``pages_per_split`` and ``variant`` override the
    choice (``kernel_probe.py paged-modes`` sweeps them); a variant that
    cannot take the shape raises ``ValueError``."""
    r = s * (h // hkv)
    decode_ok = d in DECODE_DS and p % DECODE_KEYS == 0
    chunk_ok = (d in DECODE_DS and p == 64 and qdtype == torch.bfloat16
                and kvdtype in (torch.bfloat16, torch.int8))
    if variant is None:
        if decode_ok and (s <= DECODE_MAX_S or (
                not chunk_ok and s <= DECODE_ALONE_MAX_S)):
            variant = "decode"
        elif chunk_ok:
            variant = "chunk"
        else:
            variant = "rows"
    if variant == "decode":
        if not decode_ok:
            raise ValueError(f"the decode variant takes head_dim "
                             f"{' or '.join(map(str, DECODE_DS))} "
                             f"and pages of a multiple of {DECODE_KEYS} "
                             f"tokens, got D={d}, P={p}")
        rows = next(n for n in DECODE_ROWS if n >= min(r, DECODE_ROWS[-1]))
        blocks = _cdiv(r, rows)
        if blocks > MAX_ROW_BLOCKS:
            raise ValueError(f"paged kernel: {r} query rows need {blocks} "
                             f"row blocks (max {MAX_ROW_BLOCKS})")
        if pages_per_split is None:
            want = _cdiv(DECODE_TARGET_CTAS, b * hkv * blocks)
            pages_per_split = mp // want  # at least `want` splits
        # splits x row blocks share the grid's z axis
        fewest = _cdiv(mp, MAX_ROW_BLOCKS // blocks)
        pages_per_split = max(1, fewest, min(pages_per_split, mp))
        kv_size = kvdtype.itemsize
        items = pages_per_split * _cdiv(p // DECODE_KEYS, DECODE_WARPS)
        stages = max(1, min(DECODE_MAX_STAGES, items,
                            DECODE_RING_BYTES // _decode_slots(kv_size, d)))
        return PagedPlan("decode", rows, blocks, _cdiv(mp, pages_per_split),
                         pages_per_split, stages,
                         decode_smem(rows, stages, kv_size, d))
    if variant == "chunk":
        if not chunk_ok:
            raise ValueError("the chunk variant takes a bfloat16 query over "
                             "bfloat16 or int8 pages of 64 tokens, head_dim "
                             f"64 or 128, got {qdtype}/{kvdtype}, P={p}, "
                             f"D={d}")
        blocks = _cdiv(r, CHUNK_ROWS)
        if blocks > MAX_ROW_BLOCKS:
            raise ValueError(f"paged kernel: {r} query rows need {blocks} "
                             f"row blocks (max {MAX_ROW_BLOCKS})")
        return PagedPlan("chunk", CHUNK_ROWS, blocks, 1, mp, 2,
                         chunk_smem(d))
    if variant != "rows":
        raise ValueError(f"unknown paged attention variant {variant!r}")
    rows, blocks, smem = row_plan(s, h, hkv, d, p)
    return PagedPlan("rows", rows, blocks, 1, mp, 1, smem)


def _launch(q, k_pages, v_pages, block_table, fills, k_scales, v_scales,
            plan: Optional[PagedPlan] = None):
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
    if hkv > 65535 or b > 65535:
        raise ValueError("paged kernel grid takes B, H_kv <= 65535")
    if plan is None:
        plan = paged_plan(b, s, h, hkv, d, p_sz, mp, q.dtype, k_pages.dtype)
    out = torch.empty_like(q)
    part = None
    if plan.splits > 1:  # the splits' partials, merged in split order
        part = torch.empty((b, hkv, plan.splits, plan.blocks * plan.rows,
                            part_stride(d)), dtype=torch.float32,
                           device=device)
    lib = kernels.library()
    rc = lib.port_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        block_table.data_ptr(), fills.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        b, s, h, hkv, d, n, p_sz, mp, VARIANTS[plan.variant], plan.rows,
        plan.splits, plan.pages_per_split, plan.stages, float(d ** -0.5),
        qcode, kvcode, *kernels.launch_args(device))
    kernels.check(rc, "paged_attention")
    launches += 1
    variant_launches[plan.variant] += 1
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
