"""BERT-base encoder with MLM and classification heads (counterpart of
``pyspark_tf_gke_tpu/models/bert.py``; the BASELINE config-5 workload,
BERT-base fine-tuned on TFRecord shards).

Same configuration fields, parameter names (flax paths such as
``encoder/layer_3/attention/query/kernel``) and numerics as the JAX
model: post-LN blocks, learned positions and token types, gelu (tanh
approximation), LayerNorm eps 1e-12, f32 logits.

* Every LayerNorm runs through K3/K3b (``ops/layernorm.py``):
  ``ln_attn`` and ``ln_mlp`` as ``LN(x + residual)`` with the add inside
  the kernel, ``ln_embed`` and ``mlm_ln`` plain; outputs at the compute
  dtype.
* Self-attention runs through K2f/K2dq/K2dkv (non-causal, with the key
  padding mask) on the card, at any length; ``use_flash=False`` is
  refused there (on the CPU, ``True`` selects the flash plain version).
  Given a ``torch.distributed`` sp group of more than one rank, each
  rank holds one sequence block and attention goes to
  ``ops.attention.ring_attention`` (``sp_impl="ring"``) or
  ``ulysses_attention`` (``"ulysses"``); the encoder embeds its block at
  global positions ``rank * S_local + arange(S_local)``, and the
  classifier reads the sequence's first token, broadcast from rank 0 of
  the group.
* ``use_kernels=False`` asks for the plain PyTorch version of every
  kernel on any device (the reference the kernels are held against).
* The token embeddings gather rows of the f32 table (the JAX model's
  one-hot matmul gives the same forward; ``models/embedding.py``).
* ``num_experts > 0`` replaces the dense FFN of every ``moe_every``-th
  layer with a ``moe`` submodule (``models/moe.py``); each layer returns
  ``(hidden, aux)``, the encoder ``(hidden, sum of aux)`` and the model's
  ``aux_loss`` is that sum (0 for a dense config). MoE under an sp group
  of more than one rank raises (P11c: the capacity and the aux loss's
  means are global over the sequence in the JAX model).

Weights: ``param_dtype=None`` keeps them in ``cfg.dtype`` without
gradients; ``torch.float32`` keeps trainable f32 master weights cast to
``cfg.dtype`` at use (training). :func:`init_params` draws them from a
numpy seed; :func:`bert_params_from_flax` converts the JAX model's
parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pyspark_tf_gke_tpu_torch.models.embedding import TokenEmbed
from pyspark_tf_gke_tpu_torch.models.layers import (COLUMN, ROW, Dense,
                                                    FusedLayerNorm,
                                                    flax_parameters,
                                                    init_flax_params,
                                                    load_flax_params)
from pyspark_tf_gke_tpu_torch.models.moe import MoELayer
from pyspark_tf_gke_tpu_torch.ops.attention import (broadcast_first,
                                                    dot_product_attention,
                                                    ring_attention, sp_world,
                                                    ulysses_attention)
from pyspark_tf_gke_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # training: recompute each layer in the backward
    use_flash: Optional[bool] = None  # CUDA: None/True = the kernel
    # the sp group's engine when the model is given one of > 1 rank
    sp_impl: str = "ring"
    # Mixture-of-Experts: num_experts > 0 replaces the dense FFN of every
    # moe_every-th layer with a MoELayer (models/moe.py)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 2
    capacity_factor: float = 1.25

    def __post_init__(self):
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_impl must be 'ring' or 'ulysses', got {self.sp_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _norm(cfg: BertConfig, use_kernels: bool,
          param_dtype: Optional[torch.dtype]) -> FusedLayerNorm:
    return FusedLayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                          use_fused=use_kernels,
                          trainable=param_dtype is not None)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.sp_group = sp_group
        h = cfg.hidden_size
        self.query = Dense(h, h, cfg.dtype, param_dtype, axes=COLUMN)
        self.key = Dense(h, h, cfg.dtype, param_dtype, axes=COLUMN)
        self.value = Dense(h, h, cfg.dtype, param_dtype, axes=COLUMN)
        self.out = Dense(h, h, cfg.dtype, param_dtype, axes=ROW)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor):
        cfg = self.cfg
        b, s, _ = hidden.shape
        shape = (b, s, -1, cfg.head_dim)  # this rank's heads under tp
        q = self.query(hidden).reshape(shape)
        k = self.key(hidden).reshape(shape)
        v = self.value(hidden).reshape(shape)
        if self.use_kernels and q.device.type == "cuda" \
                and cfg.use_flash is False:
            raise ValueError("use_flash=False is not run on CUDA: BERT's "
                             "attention runs through the flash kernel there")
        if sp_world(self.sp_group) > 1:
            fn = (ulysses_attention if cfg.sp_impl == "ulysses"
                  else ring_attention)
            out = fn(q, k, v, self.sp_group, kv_mask=mask,
                     use_flash=cfg.use_flash if self.use_kernels else False)
        elif self.use_kernels and (q.device.type == "cuda" or cfg.use_flash):
            out = flash_attention(q, k, v, kv_mask=mask)
        else:
            out = dot_product_attention(q, k, v, mask=mask[:, None, None, :])
        return self.out(out.reshape(b, s, -1))


class BertLayer(nn.Module):
    """Post-LN block: ``(hidden, mask) -> (hidden, aux)``, ``aux`` the
    MoE FFN's load-balance loss (``use_moe``) or 0."""

    def __init__(self, cfg: BertConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None, sp_group=None,
                 use_moe: bool = False):
        super().__init__()
        if use_moe and sp_world(sp_group) > 1:
            raise NotImplementedError(
                "MoE under an sp group of more than one rank is not ported "
                "to pyspark_tf_gke_tpu_torch yet (ROADMAP, P11c): the capacity "
                "and the aux loss's means are global over the sequence")
        self.attention = BertSelfAttention(cfg, use_kernels, param_dtype,
                                           sp_group)
        self.ln_attn = _norm(cfg, use_kernels, param_dtype)
        if use_moe:
            self.moe = MoELayer(cfg.num_experts, cfg.hidden_size,
                                cfg.intermediate_size, cfg.moe_top_k,
                                cfg.capacity_factor, cfg.dtype,
                                trainable=param_dtype is not None,
                                device=torch.get_default_device())
        else:
            self.mlp_in = Dense(cfg.hidden_size, cfg.intermediate_size,
                                cfg.dtype, param_dtype, axes=COLUMN)
            self.mlp_out = Dense(cfg.intermediate_size, cfg.hidden_size,
                                 cfg.dtype, param_dtype, axes=ROW)
        self.ln_mlp = _norm(cfg, use_kernels, param_dtype)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.ln_attn(self.attention(hidden, mask), residual=hidden)
        if hasattr(self, "moe"):
            mlp, aux = self.moe(hidden)
        else:
            mlp = self.mlp_out(F.gelu(self.mlp_in(hidden), approximate="tanh"))
            aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        return self.ln_mlp(mlp, residual=hidden), aux


def layer_uses_moe(cfg: BertConfig, i: int) -> bool:
    """Whether layer ``i`` holds the MoE FFN (every ``moe_every``-th)."""
    return cfg.num_experts > 0 and (i + 1) % cfg.moe_every == 0


def run_layers(module: nn.Module, cfg: BertConfig, hidden: torch.Tensor,
               mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``module``'s ``layer_0 .. layer_{L-1}`` over ``hidden``, each
    recomputed in the backward under ``cfg.remat``; returns the hidden
    states and the layers' summed aux loss."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(cfg.num_layers):
        layer = getattr(module, f"layer_{i}")
        if remat:
            hidden, aux = checkpoint(layer, hidden, mask, use_reentrant=False)
        else:
            hidden, aux = layer(hidden, mask)
        aux_total = aux_total + aux
    return hidden, aux_total


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        self.sp_group = sp_group
        h = cfg.hidden_size
        self.word_embeddings = TokenEmbed(cfg.vocab_size, h, cfg.dtype,
                                          param_dtype, ("vocab", "embed"))
        self.position_embeddings = TokenEmbed(cfg.max_position_embeddings,
                                              h, cfg.dtype, param_dtype,
                                              (None, "embed"))
        self.token_type_embeddings = TokenEmbed(cfg.type_vocab_size, h,
                                                cfg.dtype, param_dtype,
                                                (None, "embed"))
        self.ln_embed = _norm(cfg, use_kernels, param_dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(
                cfg, use_kernels, param_dtype, sp_group,
                layer_uses_moe(cfg, i)))

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(hidden, aux_loss)``: the ``[B, S, H]`` hidden states (this
        rank's block under sp) and the layers' summed MoE aux loss."""
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            mask = torch.ones((b, s), dtype=torch.bool, device=dev)
        else:
            mask = attention_mask.bool().contiguous()
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.long, device=dev)
        offset = 0
        if sp_world(self.sp_group) > 1:
            offset = torch.distributed.get_rank(self.sp_group) * s
        positions = torch.arange(offset, offset + s, device=dev)[None]
        hidden = (self.word_embeddings(input_ids.long())
                  + self.position_embeddings(positions)
                  + self.token_type_embeddings(token_type_ids.long()))
        return run_layers(self, self.cfg, self.ln_embed(hidden), mask)


class BertForPretraining(nn.Module):
    """Encoder + MLM head + sequence-level classifier (the fine-tune
    head of config 5). Returns ``{"mlm_logits" [B, S, V] f32,
    "cls_logits" [B, num_labels] f32, "aux_loss"}``, the MoE layers'
    summed load-balance loss (0 for a dense config)."""

    spmd = None  # set by the trainer on a mesh (parallel/spmd.py)

    def __init__(self, cfg: BertConfig, num_labels: int = 2,
                 use_kernels: bool = True,
                 param_dtype: Optional[torch.dtype] = None, sp_group=None):
        super().__init__()
        self.cfg = cfg
        self.sp_group = sp_group
        h = cfg.hidden_size
        self.encoder = BertEncoder(cfg, use_kernels, param_dtype, sp_group)
        self.mlm_transform = Dense(h, h, cfg.dtype, param_dtype,
                                   axes=("embed", "embed_out"))
        self.mlm_ln = _norm(cfg, use_kernels, param_dtype)
        self.mlm_head = Dense(h, cfg.vocab_size, cfg.dtype, param_dtype,
                              axes=("embed", "vocab"))
        self.pooler = Dense(h, h, cfg.dtype, param_dtype,
                            axes=("embed", "embed_out"))
        self.classifier = Dense(h, num_labels, cfg.dtype, param_dtype,
                                axes=("embed", None))

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                train: bool = True) -> Dict[str, torch.Tensor]:
        """``train`` is the JAX model's embedding switch (one-hot matmul
        against gather); both give the same numbers here."""
        hidden, aux_loss = self.encoder(input_ids, token_type_ids,
                                        attention_mask)
        mlm = F.gelu(self.mlm_transform(hidden), approximate="tanh")
        mlm_logits = self.mlm_head(self.mlm_ln(mlm))
        if self.mlm_head.kernel.shape[1] != self.cfg.vocab_size:
            mlm_logits = self.spmd.tp.gather_from(mlm_logits, -1)
        first = hidden[:, 0]
        if sp_world(self.sp_group) > 1:
            first = broadcast_first(first, self.sp_group)
        pooled = torch.tanh(self.pooler(first))
        return {"mlm_logits": mlm_logits.float(),
                "cls_logits": self.classifier(pooled).float(),
                "aux_loss": aux_loss}

    @property
    def device(self) -> torch.device:
        return self.classifier.kernel.device

    def flax_parameters(self) -> Dict[str, nn.Parameter]:
        """``{flax path: parameter}``."""
        return flax_parameters(self)

    def load_params(self, params: Dict[str, torch.Tensor]
                    ) -> "BertForPretraining":
        """Copy a flat flax-path tree into the model, casting to each
        parameter's dtype."""
        load_flax_params(self, params)
        return self


def bert_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``BertForPretraining`` parameter tree (nested dicts of
    numpy arrays, unboxed) as the port's flat flax-path tree of f32
    tensors (``train/export.py params_from_flax``, whose int8 leaves a
    BERT tree does not have). A MoE layer's ``moe/{router, w_in, b_in,
    w_out, b_out}`` carry over as they are: the port keeps their flax
    shapes."""
    from pyspark_tf_gke_tpu_torch.train.export import params_from_flax

    return params_from_flax(params)


def init_params(cfg: BertConfig, num_labels: int = 2,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random f32 parameters from a numpy seed, with the flax
    initialisers' shapes and laws: kernels, embeddings and the MoE
    router and expert weights normal(0, 0.02), biases 0, norm scales
    1."""
    return init_flax_params(lambda: BertForPretraining(cfg, num_labels),
                            seed)
