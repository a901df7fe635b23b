"""ResNet-50 (v1.5) for training (counterpart of
``pyspark_tf_gke_tpu/models/resnet.py``).

Two of the JAX model's normalisation variants are ported:

* ``norm_variant="fused"``: :class:`FusedBottleneckBlock`, whose 1x1 convs
  are the K4 kernels (``ops/fused_matmul.py``): conv1, conv3 and the
  projection write their raw output and its BatchNorm sums in one pass,
  and conv3 applies norm2's normalise+relu to its input as it reads it;
* ``norm_variant="bn"`` (the JAX default): :class:`BottleneckBlock`,
  plain convs and :class:`BatchNorm` — no port kernel, the step's
  yardstick.

``fused3`` (K5, the fused 3x3 conv), ``bn_f32``, ``gn``, ``none``,
``nf`` and ``s2d_stem=True`` raise ``NotImplementedError`` naming their
ROADMAP item.

The public surface keeps the JAX layouts: NHWC activations, and flax's
parameter names and shapes (``conv1_kernel [cin, f]``, ``conv2_kernel
[3, 3, f, f]`` HWIO, ``Dense_0.kernel [in, out]``, ``norm1_scale``, the
running statistics ``norm1_mean`` / ``norm1_var`` as buffers), so
:func:`params_from_flax` is a name map and ``state_dict()`` keys are
flax paths joined by dots. The 3x3 and stem convs run through
``F.conv2d`` on a channels-last view of the NHWC tensor (the JAX package
runs them in XLA, outside any Pallas kernel), with XLA's SAME padding,
which is asymmetric at stride 2 (:func:`same_pads`).

BatchNorm is flax's, not ``torch.nn.BatchNorm2d``: statistics in f32 as
``E[x^2] - E[x]^2`` clamped at 0, the biased variance into the running
average, ``running = 0.9 * running + 0.1 * batch`` (flax's momentum
weights the old value), normalise in f32 and round to the compute
dtype. ``forward(x, train)`` takes the mode explicitly, as the JAX
model does: ``train=True`` normalises with the batch statistics and
updates the running ones in place (under ``no_grad``); ``train=False``
reads them. ``nn.Module.training`` is not used.

Parameters are f32 master weights, cast to the compute dtype at each use
(flax's f32 ``param_dtype`` under a bf16 ``dtype``); the weights come
from a seeded ``torch.Generator`` with flax's initialisers (a truncated
``lecun_normal``; norm3's scale starts at zero). ``use_kernels=False``
asks for the plain PyTorch version of every kernel on any device.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.layers import Dense
from pyspark_tf_gke_tpu_torch.ops.fused_matmul import (bn_fold,
                                                       norm_relu_matmul,
                                                       norm_relu_matmul_plain,
                                                       stats_to_moments)

MOMENTUM = 0.9
EPSILON = 1e-5

_UNPORTED = {
    "fused3": "norm_variant='fused3' needs K5, the fused 3x3 conv "
              "(ops/pallas/fused_conv3.py), not ported yet (ROADMAP, queue 2)",
    "bn_f32": "norm_variant='bn_f32' is not ported (ROADMAP, P10)",
    "gn": "norm_variant='gn' is not ported (ROADMAP, P10)",
    "none": "norm_variant='none' is not ported (ROADMAP, P10)",
    "nf": "norm_variant='nf' is not ported (ROADMAP, P10)",
}


# -- layout helpers -----------------------------------------------------------


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ``(low, high)``, the extra
    element on the high side (56 -> 28 at 3x3 stride 2 pads (0, 1),
    where ``padding=1`` would pad (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, kernel_hwio: torch.Tensor,
              stride: int = 1,
              padding: Union[str, Sequence[Tuple[int, int]]] = "SAME"
              ) -> torch.Tensor:
    """``lax.conv_general_dilated(x, k, (s, s), padding, ("NHWC", "HWIO",
    "NHWC"))`` through ``F.conv2d`` on channels-last views: ``x [B, H, W,
    C]`` and ``kernel [kh, kw, C, O]`` in one dtype; returns ``[B, H', W',
    O]``."""
    kh, kw = kernel_hwio.shape[:2]
    if padding == "SAME":
        padding = (same_pads(x.shape[1], kh, stride),
                   same_pads(x.shape[2], kw, stride))
    (ph0, ph1), (pw0, pw1) = padding
    xt = x.permute(0, 3, 1, 2)
    wt = kernel_hwio.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if ph0 == ph1 and pw0 == pw1:
        out = F.conv2d(xt, wt, stride=stride, padding=(ph0, pw0))
    else:
        out = F.conv2d(F.pad(xt, (pw0, pw1, ph0, ph1)), wt, stride=stride)
    return out.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")`` on NHWC: pads
    with -inf (on the high side where SAME is asymmetric), then pools
    with no padding."""
    (ph0, ph1), (pw0, pw1) = (same_pads(x.shape[1], window, stride),
                              same_pads(x.shape[2], window, stride))
    xt = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1),
               value=float("-inf"))
    return F.max_pool2d(xt, window, stride).permute(0, 2, 3, 1)


# -- initialisers -------------------------------------------------------------


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at 2 standard deviations,
    rescaled to variance ``1 / fan_in`` (std / 0.8796...)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _param(shape, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32))


# -- BatchNorm ----------------------------------------------------------------


def _moments(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (last axis) mean and biased variance of an f32 tensor,
    ``E[x^2] - E[x]^2`` clamped at 0, as flax's BatchNorm computes them."""
    dims = tuple(range(xf.dim() - 1))
    mean = xf.mean(dims)
    return mean, torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)


def _update_running(mean_buf: torch.Tensor, var_buf: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor) -> None:
    with torch.no_grad():
        mean_buf.copy_(MOMENTUM * mean_buf + (1.0 - MOMENTUM) * mean)
        var_buf.copy_(MOMENTUM * var_buf + (1.0 - MOMENTUM) * var)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the last axis: f32 ``scale`` / ``bias`` and running ``mean`` / ``var``
    (buffers)."""

    def __init__(self, features: int, dtype: torch.dtype,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.scale = _param((features,), 0.0 if zero_scale else 1.0)
        self.bias = _param((features,))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, var = _moments(xf)
            _update_running(self.mean, self.var, mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, use_bias=False,
    dtype=dtype)``: ``kernel [kh, kw, cin, features]`` (HWIO)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16,
                 padding="SAME"):
        super().__init__()
        self.stride, self.dtype, self.padding = stride, dtype, padding
        self.kernel = _param((kernel_size, kernel_size, cin, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x.to(self.dtype), self.kernel.to(self.dtype),
                         self.stride, self.padding)


# -- blocks -------------------------------------------------------------------


class BottleneckBlock(nn.Module):
    """``norm_variant="bn"``: conv / BatchNorm / relu three times, with a
    projection shortcut where the shape changes (``resnet.py:42-62``)."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        f = features
        self.Conv_0 = Conv(cin, f, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(f, dtype)
        self.Conv_1 = Conv(f, f, 3, stride, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(f, dtype)
        self.Conv_2 = Conv(f, 4 * f, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(4 * f, dtype, zero_scale=True)
        if stride != 1 or cin != 4 * f:
            self.conv_proj = Conv(cin, 4 * f, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(4 * f, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), train)
        return torch.relu(residual + y)


class FusedBottleneckBlock(nn.Module):
    """``norm_variant="fused"`` (``resnet.py:228-413``): the 1x1 convs are
    :func:`norm_relu_matmul` (K4f forward, K4dx and K4dw backward) with
    BatchNorm statistics from the kernel's epilogue; conv3 and the
    residual read raw conv outputs and fold the norm in. The 3x3 conv is
    ``F.conv2d`` on the materialised relu(norm1), with norm2's moments
    from one f32 reduction, as the JAX block's XLA branch has it."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype, use_kernels: bool = True):
        super().__init__()
        f = features
        self.stride, self.dtype, self.use_kernels = stride, dtype, use_kernels
        self.conv1_kernel = _param((cin, f))
        self.conv3_kernel = _param((f, 4 * f))
        self.conv2_kernel = _param((3, 3, f, f))
        self.needs_proj = stride != 1 or cin != 4 * f
        if self.needs_proj:
            self.proj_kernel = _param((cin, 4 * f))
        norms = [("norm1", f), ("norm2", f), ("norm3", 4 * f)]
        if self.needs_proj:
            norms.append(("norm_proj", 4 * f))
        for name, dim in norms:
            setattr(self, f"{name}_scale",
                    _param((dim,), 0.0 if name == "norm3" else 1.0))
            setattr(self, f"{name}_bias", _param((dim,)))
            self.register_buffer(f"{name}_mean", torch.zeros(dim))
            self.register_buffer(f"{name}_var", torch.ones(dim))

    def _fold(self, name: str, train: bool, moments=None):
        """moments -> running-average update -> folded ``(a, b)``; eval
        reads the running statistics (``_fold_stats``, ``:289-310``)."""
        ra_mean = getattr(self, f"{name}_mean")
        ra_var = getattr(self, f"{name}_var")
        if train:
            mean, var = moments
            _update_running(ra_mean, ra_var, mean, var)
        else:
            mean, var = ra_mean, ra_var
        return bn_fold(mean, var, getattr(self, f"{name}_scale"),
                       getattr(self, f"{name}_bias"), EPSILON)

    def _conv_bn(self, x_flat: torch.Tensor, w: torch.Tensor, name: str,
                 train: bool, a_in=None, b_in=None):
        """One fused 1x1 conv + BN step (``_fused_conv_bn``, ``:312-330``):
        returns the raw output and its folded ``(a, b)``."""
        matmul = (norm_relu_matmul if self.use_kernels
                  else norm_relu_matmul_plain)
        relu = a_in is not None
        if train:
            y, s, ss = matmul(x_flat, w.to(self.dtype), a_in, b_in, relu=relu,
                              want_stats=True)
            a, b = self._fold(name, True, stats_to_moments(s, ss, y.shape[0]))
        else:
            y = matmul(x_flat, w.to(self.dtype), a_in, b_in, relu=relu)
            a, b = self._fold(name, False)
        return y, a, b

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        bsz, h, w_, cin = x.shape
        f, dt, s = self.conv1_kernel.shape[1], self.dtype, self.stride
        x = x.to(dt).contiguous()
        x_flat = x.reshape(-1, cin)
        y1, a1, b1 = self._conv_bn(x_flat, self.conv1_kernel, "norm1", train)
        # norm1 + relu materialise for the 3x3 conv
        n1 = torch.relu(y1.float() * a1 + b1).to(dt).reshape(bsz, h, w_, f)
        y2 = conv_nhwc(n1, self.conv2_kernel.to(dt), s).contiguous()
        # norm2's moments: one f32 reduction of y2
        moments = _moments(y2.float()) if train else None
        a2, b2 = self._fold("norm2", train, moments)
        h2, w2 = y2.shape[1], y2.shape[2]
        # conv3 normalises + relus raw y2 as it reads it
        y3, a3, b3 = self._conv_bn(y2.reshape(-1, f), self.conv3_kernel,
                                   "norm3", train, a2, b2)
        if self.needs_proj:
            xs = x[:, ::s, ::s, :].contiguous().reshape(-1, cin)
            yp, ap, bp = self._conv_bn(xs, self.proj_kernel, "norm_proj",
                                       train)
            res = yp.float() * ap + bp
        else:
            res = x_flat.float()
        # norm3 + residual add + relu
        out = torch.relu(y3.float() * a3 + b3 + res)
        return out.to(dt).reshape(bsz, h2, w2, 4 * f)


# -- the network --------------------------------------------------------------


class ResNet(nn.Module):
    """``ResNet(stage_sizes, num_classes, num_filters, dtype,
    norm_variant)`` as the JAX module, on ``device`` (default ``cuda``;
    pass ``cpu`` for the plain versions), with weights from ``seed``.
    ``forward(x [B, H, W, 3], train)`` returns f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64,
                 dtype: Optional[torch.dtype] = torch.bfloat16,
                 s2d_stem: bool = False, norm_variant: str = "bn",
                 use_kernels: bool = True,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        if norm_variant in _UNPORTED:
            raise NotImplementedError(_UNPORTED[norm_variant])
        if norm_variant not in ("bn", "fused"):
            raise ValueError(
                f"norm_variant must be bn|bn_f32|gn|none|fused|fused3|nf, "
                f"got {norm_variant!r}")
        if s2d_stem:
            raise NotImplementedError(
                "s2d_stem=True (the space-to-depth stem) is not ported "
                "(ROADMAP, P10)")
        device = resolve_device(device)
        dt = dtype or torch.float32
        self.dtype = dt
        self.conv_init = Conv(3, num_filters, 7, 2, dt,
                              padding=((3, 3), (3, 3)))
        self.bn_init = BatchNorm(num_filters, dt)
        self.block_names = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                f = num_filters * 2 ** i
                if norm_variant == "fused":
                    block = FusedBottleneckBlock(cin, f, stride, dt,
                                                 use_kernels)
                else:
                    block = BottleneckBlock(cin, f, stride, dt)
                name = f"{type(block).__name__}_{len(self.block_names)}"
                self.add_module(name, block)
                self.block_names.append(name)
                cin = 4 * f
        self.Dense_0 = Dense(cin, num_classes, dt, torch.float32)
        self._init_weights(seed)
        self.to(device)

    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel" or leaf.endswith("_kernel"):
                lecun_normal_(p, int(np.prod(p.shape[:-1])), gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.conv_init(x.to(self.dtype))
        x = torch.relu(self.bn_init(x, train))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(1, 2))
        return self.Dense_0(x).float()


ResNet50 = functools.partial(ResNet, stage_sizes=(3, 4, 6, 3))


def params_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX model's ``{"params": ..., "batch_stats": ...}`` (host numpy
    arrays, nested as flax has them) as a ``state_dict`` of the port's
    model: flax paths joined by dots, f32 tensors, layouts unchanged.
    Load it with ``model.load_state_dict(...)``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(value, Mapping):
                walk(value, path)
            else:
                out[path] = torch.from_numpy(np.array(value, dtype=np.float32))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), "")
    return out
