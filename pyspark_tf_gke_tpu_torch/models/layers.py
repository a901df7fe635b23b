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

The models keep flax's parameter paths (``layer_3/attention/query/
kernel``): :func:`flax_parameters`, :func:`load_flax_params` and
:func:`init_flax_params` are the one place that maps a module's
parameters to and from such a flat tree.

``FusedLayerNorm`` keeps f32 ``scale`` and ``bias`` (trainable when
``trainable``) and calls the K3/K3b wrapper (plain math on CPU tensors);
``use_fused=False`` asks for the plain closed form on any device, with
autograd through plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.ops.layernorm import (fused_layernorm,
                                                    layernorm_plain)
from pyspark_tf_gke_tpu_torch.ops.quant import Params, QTensor


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


def flax_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """``{flax path: parameter}`` of ``module``."""
    return {name.replace(".", "/"): p for name, p in module.named_parameters()}


@torch.no_grad()
def load_flax_params(module: nn.Module, params: Params) -> None:
    """Copy a flat flax-path tree (QTensor leaves dequantized here, once)
    into ``module``, casting to each parameter's dtype."""
    own = flax_parameters(module)
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


def init_flax_params(build: Callable[[], nn.Module], seed: int) -> Params:
    """Random f32 parameters for the module ``build()`` makes, from a
    numpy seed, with the flax initialisers' shapes and laws: kernels and
    embeddings normal(0, 0.02), biases 0, norm scales 1."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {path: tuple(p.shape)
                  for path, p in flax_parameters(build()).items()}
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
