"""The pieces of ``pyspark_tf_gke_tpu/models/bert.py`` the causal LM
borrows: ``_dense`` (``:99``) and ``FusedLayerNorm`` (``:122``).

``Dense`` keeps the flax layout: ``kernel [in, out]`` and ``y = x @
kernel + bias``, with input, kernel and bias cast to the compute dtype
and the bias added after the product in that dtype — the rounding
points of ``nn.Dense(dtype=...)``. Three ways to hold the weights:

* serving (``param_dtype=None``): the weights live in the compute dtype
  and take no gradient, so the casts are no-ops;
* serving from an int8 tree: a ``QTensor`` kernel stays int8 on the
  device with its f32 column scales (``kernel_scale``). A forward at the
  JAX package's in-loop sites (``inloop=True``: the decode loops of
  ``generate``, beam search and the engine's chunks) streams it through
  K6 (``ops/int8_matmul.py``); any other forward (prefill, scoring, a
  prefill piece) dequantizes the weight into a transient and calls
  ``torch.matmul``, as the JAX package's ``dequantize_tree`` sites do.
  Both give ``x @ dtype(f32(q) * scale)``. :func:`dense_group` runs
  Dense layers that share their input (a layer's query, key and value;
  SwiGLU's gate and input) as one K6 launch there;
* training (``param_dtype=torch.float32``): trainable f32 master
  weights, cast to the compute dtype at every use, as flax keeps f32
  ``param_dtype`` parameters under a bf16 ``dtype``. Their gradients
  come back through the casts in f32.

The models keep flax's parameter paths (``layer_3/attention/query/
kernel``): :func:`flax_parameters`, :func:`load_flax_params`,
:func:`flax_tree`, :func:`flatten_flax` (a nested JAX tree of host
arrays) and :func:`init_flax_params` are the one place that maps a
module's parameters to and from such a flat tree.
:func:`build_device` places a model's parameters where they are made:
``meta`` builds shapes only (a parameter count without memory).

``FusedLayerNorm`` keeps f32 ``scale`` and ``bias`` (trainable when
``trainable``) and calls the K3/K3b wrapper (plain math on CPU tensors);
``use_fused=False`` asks for the plain closed form on any device, with
autograd through plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.embedding import TokenEmbed
from pyspark_tf_gke_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                      int8_matmul_group,
                                                      int8_matmul_plain)
from pyspark_tf_gke_tpu_torch.ops.layernorm import (fused_layernorm,
                                                    layernorm_plain)
from pyspark_tf_gke_tpu_torch.ops.quant import Params, QTensor

# the logical axes of a column-parallel (output split) and a
# row-parallel (input split) kernel: "mlp" goes to tp (LOGICAL_RULES)
COLUMN = ("embed", "mlp")
ROW = ("mlp", "embed")


class Dense(nn.Module):
    # set by the trainer on a mesh (parallel/spmd.py): a kernel split on
    # tp makes this a column- or row-parallel layer
    spmd = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True, axes: Optional[tuple] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        # the JAX model's logical axes (``_dense``: the bias takes the
        # kernel's last), read by parallel/sharding.py
        self.logical_axes = ({"kernel": axes, "bias": (axes[-1],)}
                             if axes else None)
        self.features = (in_features, out_features)
        trainable = param_dtype is not None
        store = param_dtype if trainable else dtype
        self.kernel = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=store),
            requires_grad=trainable)
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=store),
                                 requires_grad=trainable)
        self.register_buffer("kernel_scale", None)

    def hold_int8(self, qt: QTensor) -> None:
        """Keep ``qt`` as the kernel: int8 ``[in, out]`` and its f32
        column scales, on the kernel's device (serving only)."""
        if self.kernel.requires_grad:
            raise ValueError("a trainable Dense holds float weights")
        n = self.kernel.shape[1]
        if tuple(qt.q.shape) != tuple(self.kernel.shape) or (
                qt.scale.numel() != n):
            raise ValueError(f"int8 kernel {tuple(qt.q.shape)} with scales "
                             f"{tuple(qt.scale.shape)} does not fit "
                             f"{tuple(self.kernel.shape)} per column")
        device = self.kernel.device
        self.kernel = nn.Parameter(qt.q.to(device, torch.int8).contiguous(),
                                   requires_grad=False)
        self.kernel_scale = qt.scale.to(device, torch.float32).reshape(
            n).contiguous()

    def forward(self, x: torch.Tensor, inloop: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        tp = self.spmd.tp if self.spmd is not None else None
        row = tp is not None and self.kernel.shape[0] != self.features[0]
        if (tp is not None and not row
                and self.kernel.shape[1] != self.features[1]):
            # column-parallel: this rank's output columns; the input's
            # gradient is summed over the ranks
            x = tp.copy_to(x)
        if self.kernel_scale is None:
            y = torch.matmul(x, self.kernel.to(self.dtype))
        elif _streams_int8(self, inloop):
            y = int8_matmul(x, self.kernel, self.kernel_scale)
        else:
            y = int8_matmul_plain(x, self.kernel, self.kernel_scale)
        if row:
            # row-parallel: the ranks' partial products summed, then the
            # (whole) bias once
            y = tp.reduce_from(y)
        return y + self.bias.to(self.dtype)


def _streams_int8(dense: Dense, inloop: bool) -> bool:
    return (inloop and dense.use_kernels
            and dense.kernel_scale is not None)


def dense_group(denses, x: torch.Tensor, inloop: bool = False):
    """``[d(x, inloop) for d in denses]`` for Dense layers that share
    ``x``: where every one streams int8 through K6 (``inloop``), one
    grouped launch (``int8_matmul_group``) gives their products, each
    then adding its bias; otherwise each layer runs alone."""
    if not all(_streams_int8(d, inloop) for d in denses):
        return [d(x, inloop) for d in denses]
    dtype = denses[0].dtype
    ys = int8_matmul_group(x.to(dtype), [(d.kernel, d.kernel_scale)
                                         for d in denses])
    return [y + d.bias.to(d.dtype) for y, d in zip(ys, denses)]


def k6_launches(denses) -> int:
    """K6 launches an in-loop forward makes through ``denses`` run
    together (:func:`dense_group`): 1 when they stream int8 as a group,
    else one a streaming layer."""
    streaming = sum(_streams_int8(d, True) for d in denses)
    return 1 if streaming == len(denses) and streaming else streaming


class FusedLayerNorm(nn.Module):
    logical_axes = {"scale": ("norm",), "bias": ("norm",)}

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
    """Copy a flat flax-path tree into ``module``, casting to each
    parameter's dtype. A QTensor leaf stays int8 with its scales where
    it lands in a serving ``Dense`` kernel or ``TokenEmbed`` table;
    elsewhere (a trainable module) it is dequantized here, once."""
    own = flax_parameters(module)
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter tree mismatch: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for path, p in own.items():
        leaf = params[path]
        if isinstance(leaf, QTensor):
            owner = module.get_submodule(".".join(path.split("/")[:-1]))
            if not p.requires_grad and (
                    (isinstance(owner, Dense) and path.endswith("/kernel"))
                    or isinstance(owner, TokenEmbed)):
                owner.hold_int8(leaf)
                continue
            leaf = leaf.dequantize()
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {tuple(leaf.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(leaf)


def flax_tree(module: nn.Module) -> Params:
    """The module's weights as a flat flax-path tree, the inverse of
    :func:`load_flax_params`: an int8 kernel or table comes back as a
    ``QTensor`` with its scales (tensors shared, not copied)."""
    out: Params = {}
    for path, p in flax_parameters(module).items():
        owner = module.get_submodule(".".join(path.split("/")[:-1]))
        scale = (getattr(owner, "kernel_scale", None) if isinstance(
            owner, Dense) else getattr(owner, "embedding_scale", None))
        out[path] = (QTensor(p.detach(), scale, torch.float32)
                     if p.dtype == torch.int8 and scale is not None
                     else p.detach())
    return out


# the leaves flax draws from normal(0, 0.02) in the transformer models
NORMAL_LEAVES = ("kernel", "embedding", "router", "w_in", "w_out",
                 "cls_token", "pos_embedding")


def init_flax_params(build: Callable[[], nn.Module], seed: int) -> Params:
    """Random f32 parameters for the module ``build()`` makes, from a
    numpy seed, with the flax initialisers' shapes and laws: kernels,
    embeddings, the MoE router and expert weights and ViT's learned
    tokens normal(0, 0.02), biases 0, norm scales 1."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {path: tuple(p.shape)
                  for path, p in flax_parameters(build()).items()}
    params: Params = {}
    for path, shape in shapes.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in NORMAL_LEAVES:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        elif leaf == "scale":
            arr = np.ones(shape, np.float32)
        else:
            arr = np.zeros(shape, np.float32)
        params[path] = torch.from_numpy(arr)
    return params


def flatten_flax(tree: Mapping, prefix: str = "") -> Params:
    """A nested flax ``params`` tree of host arrays as ``{flax path: f32
    tensor}`` (``Dense_0/kernel``), layouts unchanged."""
    out: Params = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_flax(value, path))
        else:
            out[path] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


def build_device(device: Union[str, torch.device]) -> torch.device:
    """The device a model builds its parameters on: ``meta`` (shapes
    only), else :func:`resolve_device`'s answer."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)
