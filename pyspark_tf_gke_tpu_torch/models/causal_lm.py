"""Decoder-only causal LM with dense and paged KV caches (counterpart of
``pyspark_tf_gke_tpu/models/causal_lm.py``).

Same configuration fields, parameter names (flax paths such as
``layer_3/attention/query/kernel``) and numerics as the JAX model:
pre-LN blocks, learned or rotary positions, LayerNorm or RMSNorm, gelu
(tanh approximation) or SwiGLU, GQA/MQA through ``num_kv_heads``, f32
logits. The cache is explicit state passed in and returned, not a flax
variable collection:

* :class:`DenseCache` — ``[B, L, H_kv, D]`` per layer; a prefill forward
  writes its prefix (``_write_cache_prefix``), a decode forward writes
  each row at its own position and attends with the per-row mask.
* :class:`PagedKV` — the continuous-batching engine's page pool per
  layer plus one block table; a slot-decode forward writes each row's
  new K/V through the table, then attends with the paged kernel.

Both are updated IN PLACE (the JAX version returns new arrays).

On CUDA every causal full forward (prefill, score, training) runs
through the flash kernel, at any length; ``use_flash=False`` raises
there (on the CPU, ``True`` selects the flash plain version).
``use_kernels=False`` asks for the plain PyTorch version of every kernel
on any device (the reference the kernels are held against).

Two ways to hold the weights (``param_dtype``): ``None`` keeps them in
the compute dtype ``cfg.dtype`` without gradients (serving), and
``torch.float32`` keeps trainable f32 master weights cast to
``cfg.dtype`` at use, as the JAX model keeps f32 parameters under a bf16
``dtype`` (training). A full causal forward with grad enabled is the
training forward (``CausalLM.__call__`` ``:547-633``): flash attention
and LayerNorm differentiate through their kernels (K2dq/K2dkv, K3b),
and ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, as ``nn.remat`` does).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pyspark_tf_gke_tpu_torch.ops.attention import dot_product_attention
from pyspark_tf_gke_tpu_torch.ops.flash_attention import flash_attention
from pyspark_tf_gke_tpu_torch.ops.paged_attention import (
    paged_attention, paged_attention_chunk, paged_attention_chunk_plain)
from pyspark_tf_gke_tpu_torch.ops.quant import Params, QTensor
from pyspark_tf_gke_tpu_torch.models.embedding import TokenEmbed
from pyspark_tf_gke_tpu_torch.models.layers import Dense, FusedLayerNorm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # training: recompute each block in the backward
    use_flash: Optional[bool] = None  # CUDA: None/True = the kernel
    num_kv_heads: Optional[int] = None
    pos_embedding: str = "learned"
    rope_theta: float = 10000.0
    norm: str = "layernorm"
    ffn: str = "gelu"
    kv_cache_quant: bool = False
    kv_page_size: int = 64
    kv_num_pages: Optional[int] = None

    @property
    def paged_kv(self) -> bool:
        return self.kv_num_pages is not None

    @property
    def max_pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.kv_page_size)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        kv = self.num_kv_heads if self.num_kv_heads is not None else self.num_heads
        if self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {self.num_heads}")
        return kv


def require_flash(cfg: CausalLMConfig, device: torch.device) -> None:
    """On CUDA every causal full forward runs through the flash kernel;
    ``use_flash=False`` (kept for config.json parity) is refused there
    instead of quietly running plain attention on the card."""
    if device.type == "cuda" and cfg.use_flash is False:
        raise ValueError(
            "use_flash=False is not served on CUDA: prefill and score "
            "attention run through the flash kernel there; set use_flash "
            "to null or true in the bundle's config.json")


def llama_like(**overrides) -> CausalLMConfig:
    """Llama-architecture preset: RoPE + RMSNorm + SwiGLU."""
    defaults = dict(pos_embedding="rope", norm="rmsnorm", ffn="swiglu")
    return CausalLMConfig(**{**defaults, **overrides})


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on ``x [B, S, H, D]`` at ``positions [B, S]``
    (rotate-half, f32 angles)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def quantize_kv(x: torch.Tensor):
    """``[B, S, H, D]`` -> (int8 ``[B, S, H, D]``, f32 scale ``[B, S,
    H]``): symmetric per-(position, head) over head_dim."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


class RMSNorm(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, trainable: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32),
                                  requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + self.epsilon)
        return (xf / rms * self.scale).to(self.dtype)


def _norm(cfg: CausalLMConfig, use_kernels: bool,
          param_dtype: Optional[torch.dtype]) -> nn.Module:
    trainable = param_dtype is not None
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                       trainable)
    if cfg.norm != "layernorm":
        raise ValueError(f"norm must be 'layernorm' or 'rmsnorm', "
                         f"got {cfg.norm!r}")
    return FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                          use_fused=use_kernels, trainable=trainable)


# -- caches -------------------------------------------------------------------


class DenseCache:
    """Dense K/V cache: per layer ``k``/``v [B, L, H_kv, D]`` in the
    compute dtype, or int8 with f32 ``k_scale``/``v_scale [B, L, H_kv]``
    under ``kv_cache_quant``. Updated in place."""

    def __init__(self, cfg: CausalLMConfig, batch: int, length: int,
                 device: Union[str, torch.device]):
        store = torch.int8 if cfg.kv_cache_quant else cfg.dtype
        shape = (batch, length, cfg.kv_heads, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=store, device=device)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(shape, dtype=store, device=device)
                  for _ in range(cfg.num_layers)]
        self.k_scale = self.v_scale = None
        if cfg.kv_cache_quant:
            self.k_scale = [torch.zeros(shape[:3], device=device)
                            for _ in range(cfg.num_layers)]
            self.v_scale = [torch.zeros(shape[:3], device=device)
                            for _ in range(cfg.num_layers)]

    def write(self, layer: int, start: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write ``k/v [B, s, H_kv, D]`` at per-row offsets ``start [B]``
        (clamped so the write fits, as ``dynamic_update_slice`` does)."""
        b, s = k.shape[:2]
        length = self.k[layer].shape[1]
        start = start.long().clamp(0, length - s)
        rows = torch.arange(b, device=k.device)[:, None]
        cols = start[:, None] + torch.arange(s, device=k.device)[None, :]
        if self.k_scale is not None:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            self.k_scale[layer][rows, cols] = ks
            self.v_scale[layer][rows, cols] = vs
        self.k[layer][rows, cols] = k.to(self.k[layer].dtype)
        self.v[layer][rows, cols] = v.to(self.v[layer].dtype)


class PagedKV:
    """The paged slot cache (``_paged_cache_vars``): one page pool per
    layer, ``k_pages``/``v_pages [N, P, H_kv, D]`` (int8 plus f32
    ``[N, P, H_kv]`` scale pages under ``kv_cache_quant``), and ONE
    int32 block table ``[num_slots, max_pages]`` shared by every layer
    (the JAX model keeps an identical copy per layer). Unallocated table
    entries hold the sentinel ``N``.

    JAX drops scatter writes through a sentinel (``mode="drop"``); torch
    raises on an out-of-range index instead, and masking the indices on
    the device would cost a host sync per write. So each pool carries
    one extra TRASH page at index ``N`` that absorbs every write through
    a sentinel, and readers (the kernel, the plain version) only ever
    see the ``[0, N)`` view. Updated in place."""

    def __init__(self, cfg: CausalLMConfig, num_slots: int,
                 device: Union[str, torch.device]):
        n, ps = cfg.kv_num_pages, cfg.kv_page_size
        if cfg.max_seq_len % ps:
            raise ValueError(f"kv_page_size {ps} must divide max_seq_len "
                             f"{cfg.max_seq_len}")
        self.num_pages, self.page_size = n, ps
        store = torch.int8 if cfg.kv_cache_quant else cfg.dtype
        shape = (n + 1, ps, cfg.kv_heads, cfg.head_dim)
        layers = range(cfg.num_layers)
        self._k = [torch.zeros(shape, dtype=store, device=device) for _ in layers]
        self._v = [torch.zeros(shape, dtype=store, device=device) for _ in layers]
        self._ks = self._vs = None
        if cfg.kv_cache_quant:
            self._ks = [torch.zeros(shape[:3], device=device) for _ in layers]
            self._vs = [torch.zeros(shape[:3], device=device) for _ in layers]
        self.block_table = torch.full((num_slots, cfg.max_pages_per_slot), n,
                                      dtype=torch.int32, device=device)

    def with_table(self, block_table: torch.Tensor) -> "PagedKV":
        """A view that shares every page tensor with this pool (no copy)
        but reads and writes through ``block_table`` instead: a
        chunked-prefill piece writes its K/V straight into the pool
        through the admission's page row while the slot's own table row
        stays at the sentinel (``_paged_prefill_chunk``'s cache view)."""
        view = copy.copy(self)
        view.block_table = block_table
        return view

    def pages(self, layer: int):
        """``(k_pages, v_pages, k_scales, v_scales)`` views of ``[0, N)``."""
        n = self.num_pages
        ks = self._ks[layer][:n] if self._ks is not None else None
        vs = self._vs[layer][:n] if self._vs is not None else None
        return self._k[layer][:n], self._v[layer][:n], ks, vs

    def _safe(self, page: torch.Tensor) -> torch.Tensor:
        page = page.long()
        return torch.where((page >= 0) & (page < self.num_pages), page,
                           self.num_pages)

    def write_tokens(self, layer: int, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor) -> None:
        """Write ``k/v [B, s, H_kv, D]`` at ``positions [B, s]`` through
        the block table (page ``table[b, pos // P]``, offset ``pos %
        P``); the page index is clipped into the table as
        ``take_along_axis`` does, and sentinel pages go to the trash."""
        ps = self.page_size
        pos = positions.long()
        col = (pos // ps).clamp(max=self.block_table.shape[1] - 1)
        page = self._safe(self.block_table.long().gather(1, col))
        off = pos % ps
        if self._ks is not None:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            self._ks[layer][page, off] = ks
            self._vs[layer][page, off] = vs
        self._k[layer][page, off] = k.to(self._k[layer].dtype)
        self._v[layer][page, off] = v.to(self._v[layer].dtype)

    def write_pages(self, layer: int, pages: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> None:
        """Scatter whole pages: ``k/v [len(pages), P, H_kv, D]`` (and
        scales ``[len(pages), P, H_kv]``) into ``pages``; sentinel
        entries go to the trash page."""
        idx = self._safe(pages)
        self._k[layer][idx] = k.to(self._k[layer].dtype)
        self._v[layer][idx] = v.to(self._v[layer].dtype)
        if self._ks is not None:
            self._ks[layer][idx] = k_scale
            self._vs[layer][idx] = v_scale


# -- the model ----------------------------------------------------------------


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: CausalLMConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        hkv, d = cfg.kv_heads, cfg.head_dim
        dense = lambda i, o: Dense(i, o, cfg.dtype, param_dtype)  # noqa: E731
        self.query = dense(cfg.hidden_size, cfg.hidden_size)
        self.key = dense(cfg.hidden_size, hkv * d)
        self.value = dense(cfg.hidden_size, hkv * d)
        self.out = dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden, positions, layer: int, cache=None,
                prefill: bool = False, segment_ids=None):
        cfg = self.cfg
        b, s, _ = hidden.shape
        h, hkv, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        q = self.query(hidden).reshape(b, s, h, d)
        k = self.key(hidden).reshape(b, s, hkv, d)
        v = self.value(hidden).reshape(b, s, hkv, d)
        if cfg.pos_embedding == "rope":
            if d % 2:
                raise ValueError(f"rope needs an even head_dim, got {d}")
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None and not prefill:
            if isinstance(cache, PagedKV):
                out = self._paged_decode_attend(q, k, v, cache, layer,
                                                positions)
            else:
                out = self._decode_attend(q, k, v, cache, layer, positions)
        else:
            if prefill:  # _write_cache_prefix: rows 0..s-1 of every batch row
                cache.write(layer, torch.zeros(b, dtype=torch.long,
                                               device=q.device), k, v)
            if hkv != h:
                # GQA prefill/score: broadcast K/V to every query head (as
                # the JAX model does); the memory win is in the cache
                k = k.repeat_interleave(h // hkv, dim=2)
                v = v.repeat_interleave(h // hkv, dim=2)
            out = self._causal_attend(q, k, v, segment_ids)
        return self.out(out.reshape(b, s, cfg.hidden_size))

    def _causal_attend(self, q, k, v, segment_ids=None):
        if self.use_kernels:
            require_flash(self.cfg, q.device)
        if self.use_kernels and (q.device.type == "cuda"
                                 or self.cfg.use_flash):
            seg = (segment_ids.to(torch.int32).contiguous()
                   if segment_ids is not None else None)
            return flash_attention(q, k, v, causal=True, segment_ids=seg)
        mask = None
        if segment_ids is not None:
            mask = (segment_ids[:, None, :, None]
                    == segment_ids[:, None, None, :])
        return dot_product_attention(q, k, v, mask=mask, causal=True)

    def _decode_attend(self, q, k, v, cache: DenseCache, layer: int,
                       positions):
        """Dense-cache decode of one token or a chunk of ``s``: each row
        writes at its own position ``positions[:, 0]`` and query ``i``
        sees keys at positions ``<= positions[:, 0] + i`` (the uniform
        whole-batch step is the case of equal positions)."""
        b, s, h, d = q.shape
        hkv = k.shape[2]
        pos_b = positions[:, 0].long()
        cache.write(layer, pos_b, k, v)
        ck, cv = cache.k[layer], cache.v[layer]
        if cache.k_scale is not None:
            kf = (ck.float() * cache.k_scale[layer][..., None]).to(q.dtype)
            vf = (cv.float() * cache.v_scale[layer][..., None]).to(q.dtype)
        else:
            kf, vf = ck, cv
        g = h // hkv
        q5 = q.reshape(b, s, hkv, g, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q5.float(),
                              kf.float()) * (d ** -0.5)
        k_pos = torch.arange(ck.shape[1], device=q.device)
        q_abs = pos_b[:, None] + torch.arange(s, device=q.device)[None, :]
        valid = k_pos[None, None, :] <= q_abs[..., None]        # [B, s, L]
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf.to(q.dtype))
        return out.reshape(b, s, h, d)

    def _paged_decode_attend(self, q, k, v, cache: PagedKV, layer: int,
                             positions):
        """Write each row's new K/V through the block table (one decode
        token, or ``s`` consecutive chunk tokens at ``fill + arange(s)``)
        BEFORE attending, so in-chunk causality falls out of the
        position mask; then attend with the paged kernel."""
        s = q.shape[1]
        cache.write_tokens(layer, k, v, positions)
        kp, vp, ks, vs = cache.pages(layer)
        fills = (positions[:, -1] + 1).to(torch.int32)
        if not self.use_kernels:
            return paged_attention_chunk_plain(q, kp, vp, cache.block_table,
                                               fills, ks, vs)
        if s == 1:
            out = paged_attention(q[:, 0].contiguous(), kp, vp,
                                  cache.block_table, fills, ks, vs)
            return out[:, None]
        return paged_attention_chunk(q.contiguous(), kp, vp,
                                     cache.block_table, fills, ks, vs)


class CausalLMBlock(nn.Module):
    def __init__(self, cfg: CausalLMConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.ffn not in ("gelu", "swiglu"):
            raise ValueError(f"ffn must be 'gelu' or 'swiglu', got {cfg.ffn!r}")
        self.cfg = cfg
        self.ln_attn = _norm(cfg, use_kernels, param_dtype)
        self.attention = CausalSelfAttention(cfg, use_kernels, param_dtype)
        self.ln_mlp = _norm(cfg, use_kernels, param_dtype)
        h, f = cfg.hidden_size, cfg.intermediate_size
        if cfg.ffn == "swiglu":
            self.mlp_gate = Dense(h, f, cfg.dtype, param_dtype)
        self.mlp_in = Dense(h, f, cfg.dtype, param_dtype)
        self.mlp_out = Dense(f, h, cfg.dtype, param_dtype)

    def forward(self, hidden, positions, layer: int, cache=None,
                prefill: bool = False, segment_ids=None):
        attn_in = self.ln_attn(hidden)
        hidden = hidden + self.attention(attn_in, positions, layer, cache,
                                         prefill, segment_ids)
        mlp_in = self.ln_mlp(hidden)
        if self.cfg.ffn == "swiglu":
            mlp = F.silu(self.mlp_gate(mlp_in)) * self.mlp_in(mlp_in)
        else:
            mlp = F.gelu(self.mlp_in(mlp_in), approximate="tanh")
        return hidden + self.mlp_out(mlp)


class CausalLM(nn.Module):
    """Pre-LN decoder stack with an untied LM head. Parameters follow
    the flax tree: ``wte``, ``wpe`` (learned positions), ``layer_{i}``,
    ``ln_final``, ``lm_head``. ``param_dtype=None`` holds the weights in
    ``cfg.dtype`` without gradients (serving); ``torch.float32`` holds
    trainable f32 weights cast to ``cfg.dtype`` at use (training)."""

    def __init__(self, cfg: CausalLMConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.pos_embedding not in ("learned", "rope"):
            raise ValueError(f"pos_embedding must be 'learned' or 'rope', "
                             f"got {cfg.pos_embedding!r}")
        self.cfg = cfg
        self.use_kernels = use_kernels
        h = cfg.hidden_size
        self.wte = TokenEmbed(cfg.vocab_size, h, cfg.dtype, param_dtype)
        if cfg.pos_embedding == "learned":
            self.wpe = TokenEmbed(cfg.max_seq_len, h, cfg.dtype, param_dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            CausalLMBlock(cfg, use_kernels, param_dtype))
        self.ln_final = _norm(cfg, use_kernels, param_dtype)
        self.lm_head = Dense(h, cfg.vocab_size, cfg.dtype, param_dtype)

    @property
    def device(self) -> torch.device:
        return self.lm_head.kernel.device

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Union[DenseCache, PagedKV, None] = None,
                prefill: bool = False,
                last_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32 logits ``[B, S, V]``.

        * ``cache=None``: full causal forward (scoring).
        * ``prefill=True`` with a :class:`DenseCache`: full causal
          forward that also writes every layer's K/V prefix.
        * otherwise a decode forward against ``cache`` at explicit
          ``positions [B, s]`` (the per-row write offsets, mask and
          position-embedding indices).

        ``last_index [B]`` applies the final norm and head only at one
        position per row (returns ``[B, 1, V]``) — prefill needs just the
        last real token's logits.
        """
        b, s = input_ids.shape
        if prefill and not isinstance(cache, DenseCache):
            raise ValueError("prefill writes a DenseCache")
        decode = cache is not None and not prefill
        if decode and (positions is None or positions.dim() != 2):
            raise ValueError("decode requires explicit positions of shape "
                             "[batch, s]")
        if positions is None:
            positions = torch.arange(s, device=input_ids.device).expand(b, s)
        hidden = self.wte(input_ids)
        if self.cfg.pos_embedding == "learned":
            hidden = hidden + self.wpe(positions)
        remat = (self.cfg.remat and cache is None
                 and torch.is_grad_enabled())
        for i in range(self.cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                hidden = checkpoint(block, hidden, positions, i, None, False,
                                    segment_ids, use_reentrant=False)
            else:
                hidden = block(hidden, positions, i, cache, prefill,
                               segment_ids)
        if last_index is not None:
            rows = torch.arange(b, device=hidden.device)
            hidden = hidden[rows, last_index.long()][:, None]
        hidden = self.ln_final(hidden)
        return self.lm_head(hidden).float()

    # -- parameters ------------------------------------------------------

    def flax_parameters(self):
        """``{flax path: parameter}``."""
        return {name.replace(".", "/"): p
                for name, p in self.named_parameters()}

    @torch.no_grad()
    def load_params(self, params: Params) -> "CausalLM":
        """Copy a flat flax-path tree (QTensor leaves dequantized here,
        once) into the model, casting to each parameter's dtype."""
        own = self.flax_parameters()
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise KeyError(f"parameter tree mismatch: missing {missing[:5]}, "
                           f"unexpected {extra[:5]}")
        for path, p in own.items():
            leaf = params[path]
            if isinstance(leaf, QTensor):
                leaf = leaf.dequantize()
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(leaf.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(leaf)
        return self


def init_params(cfg: CausalLMConfig, seed: int = 0) -> Params:
    """Random f32 parameters from a numpy seed, with the flax
    initialisers' shapes and laws: kernels and embeddings normal(0,
    0.02), biases 0, norm scales 1."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {path: tuple(p.shape)
                  for path, p in CausalLM(cfg).flax_parameters().items()}
    params: Params = {}
    for path, shape in shapes.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("kernel", "embedding"):
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        elif leaf == "scale":
            arr = np.ones(shape, np.float32)
        else:
            arr = np.zeros(shape, np.float32)
        params[path] = torch.from_numpy(arr)
    return params


# -- generation -----------------------------------------------------------------


def _filter_logits(logits: torch.Tensor, top_k: Optional[int],
                   top_p) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p (nucleus) mass
    to NEG_INF. ``top_p`` may be a float or a ``[B, 1]`` tensor. Keeps
    tokens whose EXCLUSIVE cumulative mass is below ``top_p`` — the top
    token always survives."""
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def gumbel_argmax(logits: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row (the Gumbel-max rule
    ``jax.random.categorical`` uses), from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.inference_mode()
def generate(model: CausalLM, prompt_ids, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             repetition_penalty: Optional[float] = None) -> torch.Tensor:
    """Whole-batch autoregressive decoding: one prefill forward fills
    the dense cache, then single-token decode steps. The last token is
    sampled from the carried logits (its forward would be unread).
    Returns ``[B, S_prompt + max_new_tokens]``; after ``eos_token_id``
    rows are padded with eos. Sampling draws from ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 when None)."""
    cfg = model.cfg
    device = model.device
    if not isinstance(prompt_ids, torch.Tensor):
        prompt_ids = torch.from_numpy(np.asarray(prompt_ids))
    prompt = prompt_ids.to(device=device, dtype=torch.long)
    b, s_prompt = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if s_prompt + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt {s_prompt} + {max_new_tokens} new tokens "
                         f"exceeds max_seq_len {cfg.max_seq_len}")
    if repetition_penalty is not None and repetition_penalty <= 0:
        raise ValueError(
            f"repetition_penalty must be > 0, got {repetition_penalty}")
    greedy = temperature <= 0
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    cache = DenseCache(cfg, b, cfg.max_seq_len, device)
    logits = model(prompt, cache=cache, prefill=True,
                   last_index=torch.full((b,), s_prompt - 1,
                                         device=device))[:, 0]
    seen = None
    if repetition_penalty is not None:
        seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool,
                           device=device)
        seen[torch.arange(b, device=device)[:, None], prompt] = True
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    rows = torch.arange(b, device=device)

    def emit(logits, done):
        if seen is not None:
            adj = torch.where(logits > 0, logits / repetition_penalty,
                              logits * repetition_penalty)
            logits = torch.where(seen, adj, logits)
        if greedy:
            tok = torch.argmax(logits, dim=-1)
        else:
            tok = gumbel_argmax(_filter_logits(logits / temperature, top_k,
                                               top_p), generator)
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        if seen is not None:
            seen[rows, tok] = True
        return tok, done

    tokens: List[torch.Tensor] = []
    for t in range(s_prompt, s_prompt + max_new_tokens - 1):
        tok, done = emit(logits, done)
        tokens.append(tok)
        logits = model(tok[:, None], positions=torch.full(
            (b, 1), t, device=device), cache=cache)[:, 0]
    tok, done = emit(logits, done)
    tokens.append(tok)
    return torch.cat([prompt, torch.stack(tokens, dim=1)], dim=1)
