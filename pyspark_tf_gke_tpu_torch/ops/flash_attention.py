"""Flash attention forward (K2 forward) on ``[B, S, H, D]``.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/flash_attention.py``
(``flash_attention`` ``:433``, kernel ``_fwd_kernel`` ``:49``), with the
same masking: ``kv_mask [B, S]`` (True = key present) acts as an
additive 0 / NEG_INF bias, ``segment_ids [B, S]`` confine attention
within matching ids, ``causal`` hides future keys, and a query row with
no unmasked key returns 0. The kernel (``csrc/flash_attention.cu``)
also writes the per-row logsumexp ``lse [B, H, S]`` (+inf on fully
masked rows) so the backward kernels and ``flash_attention_block`` can
be added later on the same forward. The plain version is
``dot_product_attention`` with the key-padding and segment masks.

The wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels
from pyspark_tf_gke_tpu_torch.ops.attention import (dot_product_attention,
                                                    masked_scores)

NEG_INF = -1e30
HEAD_DIMS = (64,)  # instantiated in csrc/flash_attention.cu

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


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
        sq, sk = q.shape[1], k.shape[1]
        tri = torch.ones((sq, sk), dtype=torch.bool,
                         device=q.device).tril(diagonal=sk - sq)[None, None]
        mask = tri if mask is None else mask & tri
    out = dot_product_attention(q, k, v, mask=mask)
    scores = masked_scores(q, k, mask)
    lse = torch.logsumexp(scores, dim=-1)
    valid = scores.amax(dim=-1) > NEG_INF / 2
    lse = torch.where(valid, lse, torch.inf)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, S, H, D], lse [B, H, S])``."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_mask, causal, segment_ids)
    extra = tuple(t for t in (kv_mask, segment_ids) if t is not None)
    device = kernels.require_cuda("flash_attention", q, k, v, *extra)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, H, D] shape, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v must share one dtype")
    code = kernels.dtype_code(q.dtype, "flash_attention")
    if code == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError("flash kernel takes float q/k/v")
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
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=device)
    lib = kernels.library()
    rc = lib.port_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        segment_ids.data_ptr() if segment_ids is not None else None,
        out.data_ptr(), lse.data_ptr(), b, s, h, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), float(d ** -0.5), code,
        *kernels.launch_args(device))
    kernels.check(rc, "flash_attention")
    launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused attention; drop-in for ``dot_product_attention`` on
    ``[B, S, H, D]`` with key-padding, segment and causal masks."""
    return flash_attention_fwd(q, k, v, kv_mask, causal, segment_ids)[0]
