"""The pieces of ``pyspark_tf_gke_tpu/models/bert.py`` the causal LM
borrows: ``_dense`` (``:99``) and ``FusedLayerNorm`` (``:122``).

``Dense`` keeps the flax layout: ``kernel [in, out]`` and ``y = x @
kernel + bias``, with input, kernel and bias in the compute dtype and
the bias added after the product in that dtype — the rounding points
of ``nn.Dense(dtype=...)``. ``FusedLayerNorm`` keeps f32 ``scale`` and
``bias`` and calls the K3 kernel wrapper (plain math on CPU tensors);
``use_fused=False`` asks for the plain closed form on any device.
"""

from __future__ import annotations

import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.ops.layernorm import (fused_layernorm,
                                                    layernorm_plain)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.kernel.dtype), self.kernel) + self.bias


class FusedLayerNorm(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-12,
                 dtype: torch.dtype = torch.float32, use_fused: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.use_fused = use_fused
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        fn = fused_layernorm if self.use_fused else layernorm_plain
        return fn(x, self.scale, self.bias, self.epsilon,
                  residual).to(self.dtype)
