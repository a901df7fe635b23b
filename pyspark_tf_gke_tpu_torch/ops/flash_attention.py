"""Flash attention (K2 forward, K2dq and K2dkv backward) on ``[B, S, H,
D]``, differentiable.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` ``:433``, kernels ``_fwd_kernel`` ``:49``,
``_dq_kernel`` ``:162``, ``_dkv_kernel`` ``:215``, the ``custom_vjp``
``:342-364``), with the same masking: ``kv_mask [B, S]`` (True = key
present) acts as an additive 0 / NEG_INF bias, ``segment_ids [B, S]``
confine attention within matching ids, ``causal`` hides future keys,
and a query row with no unmasked key returns 0.

:func:`flash_attention` is a ``torch.autograd.Function``. Its forward
(``csrc/flash_attention.cu``) also writes the per-row logsumexp ``lse
[B, H, S]`` (+inf on fully masked rows); the residuals are (q, k, v,
masks, out, lse). The backward computes ``delta = rowsum(dO * O)`` with
torch, as the JAX package computes it outside Pallas (``:281``), then
launches K2dq and K2dkv (``csrc/flash_attention_bwd.cu``), which
recompute ``P = exp(S - lse)`` and ``dS = P * (dP - delta) * scale``.
The plain versions are :func:`flash_attention_plain` (masked
``dot_product_attention`` plus the lse) and
:func:`flash_attention_bwd_plain` (the same recompute-from-lse math).

:func:`flash_attention_block` is the ring's block engine (JAX
``flash_attention_block`` ``:456`` over ``_flash_bh_lse`` ``:368`` and
its backward ``_flash_bh_lse_bwd`` ``:383``): one non-causal block that
returns ``(out, lse [B, S, H])``, differentiable in both. It launches
the same three kernels: K2f forward, and K2dq/K2dkv with ``delta -
g_lse`` in place of ``delta`` (d lse / d scores is P, so the lse
cotangent folds into the term the kernels already subtract: ``dS = P *
(dP - delta + g_lse) * scale``). A row with no unmasked key returns
``out = 0`` and ``lse = NEG_INF`` (finite, so an lse merge stays free of
NaN); the backward keeps the kernel's raw +inf there, so that row's P,
and with it every gradient it feeds, is exactly 0, and its lse
cotangent is dropped.

Every head width D from 1 to 256 has a kernel, in bf16 and in f32:
:func:`flash_plan` picks the design and the instantiated width from D
and the dtype alone, the wrappers pass the width to the C entry points
and those check it. bf16 at D 64 and 128 runs the tensor-core designs
(``wgmma``; K2f: K/V by TMA; K2dkv: K/V once, Q/dO tiles by TMA; K2dq:
Q/dO once, K/V tiles by TMA); every other width, and f32 at every width,
runs the CUDA-core designs (``csrc/flash_attention_simt.cu``),
instantiated at 16, 32, 64, 128 and 256: a width between two of them
runs the next one up with its loads masked, the padded columns 0, the
scale ``D ** -0.5`` of the true D and the outputs written for the true D
alone. The tensor-core designs read q/k/v (and dout) through TMA tensor
maps, so each needs a 16-byte aligned base and strides (of dimensions
longer than 1) that are multiples of 8 elements: :func:`tma_compatible`;
another q/k/v layout raises, another dout is copied. The CUDA-core
designs take any layout with a contiguous head_dim.

The rounding points are the TPU kernels' at every width and design: for
inputs narrower than f32, the forward rounds P to V's dtype before P.V
(``:97``; the plain version rounds its normalised probabilities there),
and the backward rounds P to dO's dtype before ``dV += P^T dO`` and dS
to q's dtype before ``dK += dS^T Q`` and ``dQ += dS K`` (``:202``,
``:255``, ``:262``); f32 and f64 inputs keep both unrounded. The
wrappers take the plain versions only for tensors on the CPU; a CUDA
tensor launches the plan's kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels
from pyspark_tf_gke_tpu_torch.ops.attention import (dot_product_attention,
                                                    masked_scores)

NEG_INF = -1e30
# csrc/flash_attention.cuh: every head width up to MAX_HEAD_DIM has a
# kernel; bf16 at TENSOR_CORE_DIMS runs the tensor-core designs, every
# other (width, dtype) the CUDA-core design at the smallest SIMT_WIDTHS
# entry >= the width
MAX_HEAD_DIM = 256
TENSOR_CORE_DIMS = (64, 128)
SIMT_WIDTHS = (16, 32, 64, 128, 256)

launches = 0  # K2 forward launches since the last reset (chip_smoke reads it)
dq_launches = 0  # K2dq launches since the last reset
dkv_launches = 0  # K2dkv launches since the last reset
block_launches = 0  # flash_attention_block forwards on the card (each one
#   K2f launch, also counted in ``launches``)


class FlashPlan(NamedTuple):
    design: str  # "wgmma" (tensor cores, operands by TMA) or "simt"
    width: int   # the instantiated head width (>= D)


def flash_plan(d: int, dtype: torch.dtype) -> FlashPlan:
    """K2f's, K2dq's and K2dkv's design and instantiated width for head
    width ``d`` in ``dtype``, from those alone: bf16 at 64 and 128 runs
    the tensor-core designs at ``d``; every other ``d``, and f32, the
    CUDA-core design at the smallest of :data:`SIMT_WIDTHS` that holds
    it. Raises for ``d`` outside ``0 < d <= MAX_HEAD_DIM``."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim 0 < D <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if dtype == torch.bfloat16 and d in TENSOR_CORE_DIMS:
        return FlashPlan("wgmma", d)
    return FlashPlan("simt", next(w for w in SIMT_WIDTHS if w >= d))


def _mask(kv_mask: Optional[torch.Tensor],
          segment_ids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Boolean keep-mask broadcastable to ``[B, H, Sq, Sk]``."""
    mask = None
    if kv_mask is not None:
        mask = kv_mask.bool()[:, None, None, :]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _causal_mask(mask: Optional[torch.Tensor], sq: int, sk: int,
                 device) -> torch.Tensor:
    tri = torch.ones((sq, sk), dtype=torch.bool,
                     device=device).tril(diagonal=sk - sq)[None, None]
    return tri if mask is None else mask & tri


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, S, H, D], lse [B, H, S])`` in plain PyTorch."""
    mask = _mask(kv_mask, segment_ids)
    if causal:
        # fold causality into the keep-mask, so a row whose only
        # unmasked keys lie in its future counts as empty (0), as in
        # the kernel
        mask = _causal_mask(mask, q.shape[1], k.shape[1], q.device)
    out = dot_product_attention(q, k, v, mask=mask)
    scores = masked_scores(q, k, mask)
    lse = torch.logsumexp(scores, dim=-1)
    valid = scores.amax(dim=-1) > NEG_INF / 2
    lse = torch.where(valid, lse, torch.inf)
    return out, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              segment_ids: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(dq, dk, dv)`` from the saved ``lse [B, H, S]`` and ``delta =
    rowsum(dO * O) [B, H, S]``, as the K2dq/K2dkv kernels compute them:
    scores in the forward's order (scale, additive key bias, then the
    segment and causal masks replace the score), ``P = exp(S - lse)``,
    ``dS = P * (dP - delta) * scale``; for inputs narrower than f32, P
    and dS rounded to the input dtype before their products."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if kv_mask is not None:
        bias = torch.where(kv_mask.bool(), 0.0, NEG_INF).to(acc)
        s = s + bias[:, None, None, :]
    keep = _mask(None, segment_ids)
    if causal:
        keep = _causal_mask(keep, q.shape[1], k.shape[1], q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta.to(acc)[..., None]) * scale
    if torch.finfo(q.dtype).bits < 32:  # the TPU kernels' rounding points
        p = p.to(dout.dtype).to(acc)
        ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(kernel: str, q, k, v, kv_mask, segment_ids, *more):
    extra = tuple(t for t in (kv_mask, segment_ids) if t is not None)
    device = kernels.require_cuda(kernel, q, k, v, *extra, *more)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v must share one dtype")
    code = kernels.dtype_code(q.dtype, kernel)
    if code == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError("flash kernel takes float q/k/v")
    plan = flash_plan(d, q.dtype)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous head_dim axis")
    if b * h > 65535:
        raise ValueError(f"flash kernel grid takes B*H <= 65535, got {b * h}")
    for name, t, dt in (("kv_mask", kv_mask, torch.bool),
                        ("segment_ids", segment_ids, torch.int32)):
        if t is not None and (t.shape != (b, s) or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [B, S] {dt} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if plan.design == "wgmma":
        _require_tma(kernel, q, k, v)
    return device, code, plan


def tma_compatible(t: torch.Tensor) -> bool:
    """Whether the tensor-core designs' TMA tensor maps can address ``t
    [B, S, H, D]``: head_dim contiguous, the base 16-byte aligned, and the
    strides of the batch, sequence and head dimensions longer than 1
    positive multiples of 8 elements (16 bytes)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(st > 0 and st % 8 == 0
               for size, st in zip(t.shape[:3], t.stride()[:3]) if size > 1)


def _require_tma(kernel: str, q, k, v) -> None:
    if not all(tma_compatible(t) for t in (q, k, v)):
        raise ValueError(f"the bf16 {kernel} kernel reads q/k/v by TMA: it "
                         "needs 16-byte aligned bases and strides that are "
                         "multiples of 8 elements")


def tma_dout(dout: torch.Tensor) -> torch.Tensor:
    """``dout`` as the tensor-core K2dq and K2dkv read it: itself where
    TMA can address it, else a contiguous copy. Autograd may hand the
    backward an expanded or strided cotangent (a broadcast loss, a sliced
    output); unlike q, k and v, which the caller laid out, it is copied,
    not refused."""
    return dout if tma_compatible(dout) else dout.clone(
        memory_format=torch.contiguous_format)


def _bwd_dout(dout: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``dout`` as the plan's backward design reads it."""
    if flash_plan(q.shape[-1], q.dtype).design == "wgmma":
        return tma_dout(dout)
    return dout


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _strides(*tensors):
    return [st for t in tensors for st in t.stride()[:3]]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 forward: ``(out [B, S, H, D], lse [B, H, S])`` (no autograd)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, segment_ids)
    device, code, plan = _check("flash_attention", q, k, v, kv_mask,
                                segment_ids)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=device)
    lib = kernels.library()
    rc = lib.port_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        _ptr(segment_ids), out.data_ptr(), lse.data_ptr(), b, s, h, d,
        *_strides(q, k, v), int(bool(causal)), float(d ** -0.5), code,
        plan.width, *kernels.launch_args(device))
    kernels.check(rc, "flash_attention")
    launches += 1
    return out, lse


def _check_bwd(kernel, dout, q, k, v, lse, delta, kv_mask, segment_ids):
    device, code, plan = _check(kernel, q, k, v, kv_mask, segment_ids, dout,
                                lse, delta)
    b, s, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("the output gradient must match q in shape and dtype")
    if dout.stride(-1) != 1:
        raise ValueError("flash kernel needs a contiguous head_dim axis")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [B, H, S] "
                             "tensor")
    return device, code, plan


def _bwd_args(dout, q, k, v, lse, delta, kv_mask, segment_ids, causal,
              code, plan, device):
    b, s, h, d = q.shape
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            _ptr(kv_mask), _ptr(segment_ids), lse.data_ptr(), delta.data_ptr())
    tail = (b, s, h, d, *_strides(q, k, v, dout), int(bool(causal)),
            float(d ** -0.5), code, plan.width, *kernels.launch_args(device))
    return head, tail


def flash_attention_dq(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                       kv_mask: Optional[torch.Tensor] = None,
                       causal: bool = False,
                       segment_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K2dq: ``dq [B, S, H, D]`` (CUDA tensors only). The tensor-core
    design (:func:`flash_plan`) reads q, k, v and dout by TMA: q, k and v
    must be TMA-addressable, dout is copied where not (:func:`tma_dout`)."""
    global dq_launches
    dout = _bwd_dout(dout, q)
    device, code, plan = _check_bwd("flash_attention_dq", dout, q, k, v, lse,
                                    delta, kv_mask, segment_ids)
    head, tail = _bwd_args(dout, q, k, v, lse, delta, kv_mask, segment_ids,
                           causal, code, plan, device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=device)
    kernels.check(kernels.library().port_flash_attention_dq(
        *head, dq.data_ptr(), *tail), "flash_attention_dq")
    dq_launches += 1
    return dq


def flash_attention_dkv(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2dkv: ``(dk, dv)``, each ``[B, S, H, D]`` (CUDA tensors only).
    The tensor-core design (:func:`flash_plan`) reads q, k, v and dout by
    TMA: q, k and v must be TMA-addressable, dout is copied where not
    (:func:`tma_dout`)."""
    global dkv_launches
    dout = _bwd_dout(dout, q)
    device, code, plan = _check_bwd("flash_attention_dkv", dout, q, k, v,
                                    lse, delta, kv_mask, segment_ids)
    head, tail = _bwd_args(dout, q, k, v, lse, delta, kv_mask, segment_ids,
                           causal, code, plan, device)
    dk = torch.empty(q.shape, dtype=q.dtype, device=device)
    dv = torch.empty_like(dk)
    kernels.check(kernels.library().port_flash_attention_dkv(
        *head, dk.data_ptr(), dv.data_ptr(), *tail), "flash_attention_dkv")
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` for the output gradient ``dout``, from the
    forward's ``out`` and ``lse``: ``delta`` here, then K2dq and K2dkv
    (the plain version for CPU tensors)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    delta = (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)  # [B,H,S]
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, kv_mask,
                                         causal, segment_ids)
    dout, delta = dout.contiguous(), delta.contiguous()
    dq = flash_attention_dq(dout, q, k, v, lse, delta, kv_mask, causal,
                            segment_ids)
    dk, dv = flash_attention_dkv(dout, q, k, v, lse, delta, kv_mask, causal,
                                 segment_ids)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segment_ids, causal):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, segment_ids)
        ctx.save_for_backward(q, k, v, kv_mask, segment_ids, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, segment_ids, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(dout, q, k, v, out, lse, kv_mask,
                                         ctx.causal, segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention; drop-in for ``dot_product_attention`` on
    ``[B, S, H, D]`` with key-padding, segment and causal masks.
    Differentiable in q, k and v (K2dq, K2dkv)."""
    return _FlashAttention.apply(q, k, v, kv_mask, segment_ids, causal)


def _block_lse(lse: torch.Tensor) -> torch.Tensor:
    """K2f's ``lse [B, H, S]`` (+inf on empty rows) as the block entry
    returns it: ``[B, S, H]``, NEG_INF on empty rows."""
    lse = lse.transpose(1, 2)
    return torch.where(torch.isposinf(lse), NEG_INF, lse)


def flash_attention_block_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                kv_mask: Optional[torch.Tensor] = None,
                                segment_ids: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_block` in plain PyTorch, differentiable by
    autograd: ``(out [B, S, H, D], lse [B, S, H] f32)``."""
    out, lse = flash_attention_plain(q, k, v, kv_mask, False, segment_ids)
    return out, _block_lse(lse)


class _FlashAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segment_ids):
        global block_launches
        out, lse = flash_attention_fwd(q, k, v, kv_mask, False, segment_ids)
        if q.device.type == "cuda":
            block_launches += 1
        ctx.save_for_backward(q, k, v, kv_mask, segment_ids, out, lse)
        return out, _block_lse(lse)

    @staticmethod
    def backward(ctx, dout, g_lse):
        q, k, v, kv_mask, segment_ids, out, lse = ctx.saved_tensors
        acc = torch.promote_types(q.dtype, torch.float32)
        # the rows the forward returned as NEG_INF take no lse cotangent
        g = torch.where(torch.isposinf(lse), 0.0, g_lse.transpose(1, 2))
        delta = ((dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)
                 - g.to(acc))  # [B, H, S]
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, dout, lse, delta, kv_mask, False, segment_ids)
        else:
            dout, delta = dout.contiguous(), delta.float().contiguous()
            dq = flash_attention_dq(dout, q, k, v, lse, delta, kv_mask,
                                    False, segment_ids)
            dk, dv = flash_attention_dkv(dout, q, k, v, lse, delta, kv_mask,
                                         False, segment_ids)
        return dq, dk, dv, None, None


def flash_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_mask: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One non-causal attention block: ``(out [B, S, H, D], lse [B, S, H]
    f32)``, so a caller can merge partial attentions over K/V blocks held
    elsewhere by their lse (ring attention). Rows with no unmasked key
    give ``out = 0`` and ``lse = NEG_INF``. Differentiable in q, k and v
    through both outputs (K2dq, K2dkv)."""
    return _FlashAttentionBlock.apply(q, k, v, kv_mask, segment_ids)
