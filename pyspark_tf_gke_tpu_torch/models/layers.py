"""The pieces of ``pyspark_tf_gke_tpu/models/bert.py`` the causal LM
borrows: ``_dense`` (``:99``) and ``FusedLayerNorm`` (``:122``).

``Dense`` keeps the flax layout: ``kernel [in, out]`` and ``y = x @
kernel + bias``, with input, kernel and bias cast to the compute dtype
and the bias added after the product in that dtype — the rounding
points of ``nn.Dense(dtype=...)``. Two ways to hold the weights:

* serving (``param_dtype=None``): the weights live in the compute dtype
  and take no gradient, so the casts are no-ops;
* training (``param_dtype=torch.float32``): trainable f32 master
  weights, cast to the compute dtype at every use, as flax keeps f32
  ``param_dtype`` parameters under a bf16 ``dtype``. Their gradients
  come back through the casts in f32.

``FusedLayerNorm`` keeps f32 ``scale`` and ``bias`` (trainable when
``trainable``) and calls the K3/K3b wrapper (plain math on CPU tensors);
``use_fused=False`` asks for the plain closed form on any device, with
autograd through plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.ops.layernorm import (fused_layernorm,
                                                    layernorm_plain)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        trainable = param_dtype is not None
        store = param_dtype if trainable else dtype
        self.kernel = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=store),
            requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=store),
                                 requires_grad=trainable)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
                + self.bias.to(self.dtype))


class FusedLayerNorm(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-12,
                 dtype: torch.dtype = torch.float32, use_fused: bool = True,
                 trainable: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.use_fused = use_fused
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32),
                                  requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32),
                                 requires_grad=trainable)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        fn = fused_layernorm if self.use_fused else layernorm_plain
        return fn(x, self.scale, self.bias, self.epsilon,
                  residual).to(self.dtype)
