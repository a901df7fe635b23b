"""ViT image classifier (counterpart of
``pyspark_tf_gke_tpu/models/vit.py``): images patchify into tokens with
one stride-``p`` convolution, a learned [CLS] token leads them, and the
tokens ride the same ``BertLayer`` blocks as the text models.

* ``patch_embed``: a ``p x p`` stride-``p`` conv with bias, HWIO kernel
  ``[p, p, 3, hidden]`` (``models/resnet.py::conv_nhwc``, cuDNN on
  channels-last views; the JAX package runs it in XLA, outside Pallas).
  flax's SAME padding is zero here: H and W divide by ``p``.
* ``cls_token [1, 1, hidden]`` and ``pos_embedding [1, S, hidden]``, S the
  patch count + 1, cast to the compute dtype and added after the concat.
* ``ln_embed`` (K3), the ``BertLayer``s (K2f/K2dq/K2dkv over an all-ones
  key mask, K3/K3b; the MoE FFN every ``moe_every``-th layer when
  ``cfg.num_experts > 0``), ``ln_final`` on the CLS row, then the ``head``
  Dense.
* It returns ``{"logits": [B, num_classes] f32, "aux_loss": f32}``.

flax infers ``S`` on first call; here it follows from ``image_size``,
and an image of another size raises rather than broadcast the
positions. The parameters are f32 master weights cast to
``cfg.dtype`` at each use, under the JAX model's flax paths.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.models.bert import (BertConfig, BertLayer,
                                                  _norm, layer_uses_moe,
                                                  run_layers)
from pyspark_tf_gke_tpu_torch.models.layers import (Dense, build_device,
                                                    flax_parameters,
                                                    init_flax_params,
                                                    load_flax_params)
from pyspark_tf_gke_tpu_torch.models.resnet import conv_nhwc


def _check_divisible(h: int, w: int, p: int) -> None:
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} not divisible by patch size {p}")


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(hidden, (p, p), strides=(p, p), dtype=dtype)``."""

    def __init__(self, patch_size: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(patch_size, patch_size, 3,
                                               hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.kernel.to(self.dtype), stride=self.patch_size)
        return y + self.bias.to(self.dtype)


class ViTClassifier(nn.Module):
    """``cfg`` gives the encoder's widths, dtype, remat and MoE;
    ``vocab_size`` and ``max_position_embeddings`` are unused."""

    logical_axes = {"cls_token": (None, None, "embed"),
                    "pos_embedding": (None, None, "embed")}

    def __init__(self, cfg: BertConfig, num_classes: int,
                 patch_size: int = 16,
                 image_size: Tuple[int, int] = (224, 224),
                 use_kernels: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        h, w = image_size
        _check_divisible(h, w, patch_size)
        self.cfg = cfg
        self.patch_size = patch_size
        self.image_size = (h, w)
        seq = (h // patch_size) * (w // patch_size) + 1
        hid, f32 = cfg.hidden_size, torch.float32
        with torch.device(build_device(device)):
            self.patch_embed = PatchEmbed(patch_size, hid, cfg.dtype)
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hid, dtype=f32))
            self.pos_embedding = nn.Parameter(torch.zeros(1, seq, hid,
                                                          dtype=f32))
            self.ln_embed = _norm(cfg, use_kernels, f32)
            for i in range(cfg.num_layers):
                self.add_module(f"layer_{i}", BertLayer(
                    cfg, use_kernels, f32, use_moe=layer_uses_moe(cfg, i)))
            self.ln_final = _norm(cfg, use_kernels, f32)
            self.head = Dense(hid, num_classes, cfg.dtype, f32,
                              axes=("embed", None))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images [B, H, W, 3]`` at ``image_size``."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        _check_divisible(h, w, self.patch_size)
        if (h, w) != self.image_size:
            raise ValueError(f"image {h}x{w} is not the {self.image_size[0]}"
                             f"x{self.image_size[1]} the positions were "
                             "built for")
        dt = cfg.dtype
        x = self.patch_embed(images.to(dt)).reshape(b, -1, cfg.hidden_size)
        cls = self.cls_token.to(dt).expand(b, 1, cfg.hidden_size)
        hidden = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        mask = torch.ones(hidden.shape[:2], dtype=torch.bool,
                          device=hidden.device)
        hidden, aux = run_layers(self, cfg, self.ln_embed(hidden), mask)
        # K3 takes contiguous rows: the CLS rows as their own tensor
        cls_out = self.ln_final(hidden[:, :1].contiguous())
        return {"logits": self.head(cls_out[:, 0]).float(), "aux_loss": aux}

    def flax_parameters(self) -> Dict[str, nn.Parameter]:
        """``{flax path: parameter}``."""
        return flax_parameters(self)

    def load_params(self, params: Dict[str, torch.Tensor]
                    ) -> "ViTClassifier":
        """Copy a flat flax-path tree in, casting to each parameter's
        dtype."""
        load_flax_params(self, params)
        return self


def vit_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``ViTClassifier``'s parameter tree (nested dicts of numpy
    arrays, unboxed) as the port's flat flax-path tree of f32 tensors;
    every path and layout maps one to one."""
    from pyspark_tf_gke_tpu_torch.train.export import params_from_flax

    return params_from_flax(params)


def init_params(cfg: BertConfig, num_classes: int, patch_size: int = 16,
                image_size: Tuple[int, int] = (224, 224),
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random f32 parameters from a numpy seed with the flax
    initialisers' shapes and laws: ``patch_embed/kernel`` lecun-normal
    (flax ``nn.Conv``'s default: a normal truncated at 2 sigma, variance
    1 / fan_in), the other kernels, the MoE weights, ``cls_token`` and
    ``pos_embedding`` normal(0, 0.02), biases 0, norm scales 1."""
    params = init_flax_params(lambda: ViTClassifier(
        cfg, num_classes, patch_size, image_size, device="meta"), seed)
    shape = tuple(params["patch_embed/kernel"].shape)
    rng = np.random.default_rng([seed, 1])
    z = rng.standard_normal(shape)
    while (out := np.abs(z) > 2.0).any():
        z[out] = rng.standard_normal(int(out.sum()))
    fan_in = int(np.prod(shape[:-1]))
    # 0.8796...: the standard deviation of a unit normal truncated at 2
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    params["patch_embed/kernel"] = torch.from_numpy((z * std).astype(
        np.float32))
    return params
