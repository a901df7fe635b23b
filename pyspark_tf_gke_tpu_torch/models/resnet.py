"""ResNet-50 (v1.5) for training (counterpart of
``pyspark_tf_gke_tpu/models/resnet.py``), with all of the JAX model's
normalisation variants and both stems:

* ``norm_variant="fused"``: :class:`FusedBottleneckBlock`, whose 1x1 convs
  are the K4 kernels (``ops/fused_matmul.py``): conv1, conv3 and the
  projection write their raw output and its BatchNorm sums in one pass,
  and conv3 applies norm2's normalise+relu to its input as it reads it;
* ``norm_variant="fused3"``: the same block whose stride-1 3x3 convs are
  the K5 kernels too (``ops/fused_conv3.py``): conv2 reads conv1's raw
  output, applies norm1's normalise+relu as it reads it, and writes
  norm2's sums; stride-2 blocks keep ``F.conv2d``;
* ``norm_variant="bn"`` (the JAX default), ``"bn_f32"`` (the whole norm in
  f32), ``"gn"`` (GroupNorm-32) and ``"none"`` (identity):
  :class:`BottleneckBlock`, plain convs and norms — no port kernel;
* ``norm_variant="nf"``: normaliser-free, :class:`WSConv` (scaled
  weight standardisation) and :class:`NFBottleneckBlock` with the
  analytic variance schedule; no statistics, no train/eval split;
* ``s2d_stem=True``: :func:`space_to_depth` and a 4x4 stride-1 stem conv
  (``conv_init_s2d``) in place of the 7x7 stride-2 one, for every variant.

The public surface keeps the JAX layouts: NHWC activations, and flax's
parameter names and shapes (``conv1_kernel [cin, f]``, ``conv2_kernel
[3, 3, f, f]`` HWIO, ``Dense_0.kernel [in, out]``, ``norm1_scale``,
``GroupNorm_0.scale``, ``conv1.gain``, ``skip_gain``, the running
statistics ``norm1_mean`` / ``norm1_var`` as buffers), so
:func:`params_from_flax` is a name map and ``state_dict()`` keys are
flax paths joined by dots. The convs outside the kernels run through
``F.conv2d`` on a channels-last view of the NHWC tensor (the JAX package
runs them in XLA, outside any Pallas kernel), with XLA's SAME padding,
which is asymmetric at stride 2 and for the 4x4 stem (:func:`same_pads`).

BatchNorm is flax's, not ``torch.nn.BatchNorm2d``: statistics in f32 as
``E[x^2] - E[x]^2`` clamped at 0, the biased variance into the running
average, ``running = 0.9 * running + 0.1 * batch`` (flax's momentum
weights the old value), normalise in f32 and round to the norm's dtype.
``forward(x, train)`` takes the mode explicitly, as the JAX model does:
``train=True`` normalises with the batch statistics and updates the
running ones in place (under ``no_grad``); ``train=False`` reads them.
``nn.Module.training`` is not used.

Parameters are f32 master weights, cast to the compute dtype at each use
(flax's f32 ``param_dtype`` under a bf16 ``dtype``); the weights come
from a seeded ``torch.Generator`` with flax's initialisers (a truncated
``lecun_normal``; norm3's scale and ``skip_gain`` start at zero).
``use_kernels=False`` asks for the plain PyTorch version of every kernel
on any device.
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
from pyspark_tf_gke_tpu_torch.ops.fused_conv3 import (conv3_norm_stats,
                                                      conv3_norm_stats_plain)
from pyspark_tf_gke_tpu_torch.ops.fused_matmul import (bn_fold,
                                                       norm_relu_matmul,
                                                       norm_relu_matmul_plain,
                                                       stats_to_moments)

MOMENTUM = 0.9
EPSILON = 1e-5

VARIANTS = ("bn", "bn_f32", "gn", "none", "fused", "fused3", "nf")
GN_GROUPS = 32
# Variance gain of relu on a unit gaussian, sqrt(2 / (1 - 1/pi)): scaled
# weight standardisation times this keeps every NF conv's output at about
# unit variance (``resnet.py:65-70``)
GAMMA_RELU = 1.7139588594436646
NF_ALPHA = 0.2


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


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``(B, H, W, C) -> (B, H/block, W/block, C*block*block)``: each
    output pixel stacks a ``block x block`` patch of input pixels along
    the channels, in (row, column, channel) order (``resnet.py:23-39``)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth needs H,W divisible by {block}, got {h}x{w}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               c * block * block)


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


# -- norms and convs ----------------------------------------------------------


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


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=dtype)`` over
    the last axis: f32 ``scale`` / ``bias``; statistics per image and
    group, over H, W and the group's channels, in f32 as ``E[x^2] -
    E[x]^2`` clamped at 0; normalise in f32 and round to ``dtype``. No
    running statistics: ``train`` is ignored."""

    def __init__(self, features: int, dtype: torch.dtype,
                 zero_scale: bool = False):
        super().__init__()
        if features % GN_GROUPS:
            raise ValueError(f"GroupNorm-{GN_GROUPS} needs channels divisible "
                             f"by {GN_GROUPS}, got {features}")
        self.dtype = dtype
        self.scale = _param((features,), 0.0 if zero_scale else 1.0)
        self.bias = _param((features,))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        c = x.shape[-1]
        size = c // GN_GROUPS
        xf = x.float()
        grouped = xf.reshape(x.shape[0], -1, GN_GROUPS, size)
        mean = grouped.mean((1, 3))
        var = torch.clamp_min((grouped * grouped).mean((1, 3)) - mean * mean,
                              0.0)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (c,)
        mean = mean.repeat_interleave(size, -1).reshape(shape)
        var = var.repeat_interleave(size, -1).reshape(shape)
        mul = torch.rsqrt(var + EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Identity(nn.Module):
    """The ``norm_variant="none"`` norm (``resnet.py:219-225``)."""

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return x


def make_norm(variant: str, features: int, dtype: torch.dtype,
              zero_scale: bool = False) -> nn.Module:
    """The norm a :class:`BottleneckBlock` (and the stem) of ``variant``
    uses, as the JAX model's norm factory picks it (``resnet.py:452-475``):
    BatchNorm in the compute dtype (``bn``, and the stem of ``fused`` and
    ``fused3``) or in f32 (``bn_f32``), GroupNorm-32, or identity."""
    if variant == "gn":
        return GroupNorm(features, dtype, zero_scale)
    if variant == "none":
        return Identity()
    return BatchNorm(features, torch.float32 if variant == "bn_f32" else dtype,
                     zero_scale)


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


class WSConv(nn.Module):
    """Scaled weight-standardised conv of the ``nf`` variant
    (``resnet.py:115-170``): ``kernel [kh, kw, cin, features]``
    standardised per output channel over its fan-in in f32, ``(w -
    mean) * rsqrt(var * fan_in + 1e-4)`` (biased variance), times the
    per-channel ``gain``; the conv in ``dtype``, plus the f32 ``bias``
    rounded to the output's dtype."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16,
                 padding="SAME"):
        super().__init__()
        self.stride, self.dtype, self.padding = stride, dtype, padding
        self.kernel = _param((kernel_size, kernel_size, cin, features))
        self.gain = _param((features,), 1.0)
        self.bias = _param((features,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        fan_in = int(np.prod(w.shape[:3]))
        mean = w.mean((0, 1, 2), keepdim=True)
        var = w.var((0, 1, 2), correction=0, keepdim=True)
        w = (w - mean) * torch.rsqrt(var * fan_in + 1e-4) * self.gain
        y = conv_nhwc(x.to(self.dtype), w.to(self.dtype), self.stride,
                      self.padding)
        return y + self.bias.to(y.dtype)


# -- blocks -------------------------------------------------------------------


class BottleneckBlock(nn.Module):
    """``norm_variant`` ``bn``, ``bn_f32``, ``gn`` or ``none``: conv / norm
    / relu three times, with a projection shortcut where the shape changes
    (``resnet.py:42-62``); the norms are :func:`make_norm`'s, named as
    flax names them (``BatchNorm_0`` or ``GroupNorm_0``, ...)."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype, norm_variant: str = "bn"):
        super().__init__()
        f = features
        prefix = "GroupNorm" if norm_variant == "gn" else "BatchNorm"
        self.norm_names = tuple(f"{prefix}_{i}" for i in range(3))
        norm = functools.partial(make_norm, norm_variant, dtype=dtype)
        self.Conv_0 = Conv(cin, f, 1, dtype=dtype)
        self.add_module(self.norm_names[0], norm(f))
        self.Conv_1 = Conv(f, f, 3, stride, dtype=dtype)
        self.add_module(self.norm_names[1], norm(f))
        self.Conv_2 = Conv(f, 4 * f, 1, dtype=dtype)
        self.add_module(self.norm_names[2], norm(4 * f, zero_scale=True))
        if stride != 1 or cin != 4 * f:
            self.conv_proj = Conv(cin, 4 * f, 1, stride, dtype=dtype)
            self.norm_proj = norm(4 * f)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        n0, n1, n2 = (getattr(self, name) for name in self.norm_names)
        y = torch.relu(n0(self.Conv_0(x), train))
        y = torch.relu(n1(self.Conv_1(y), train))
        y = n2(self.Conv_2(y), train)
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x), train)
        return torch.relu(residual + y)


class NFBottleneckBlock(nn.Module):
    """Pre-activation normaliser-free bottleneck (``resnet.py:173-216``):
    ``h' = h + alpha * skip_gain * f(relu(h / beta) * gamma)`` with
    :class:`WSConv` convs, ``beta`` the analytic standard deviation the
    network passes in, and ``skip_gain`` a zero-initialised scalar, so
    every block starts as the identity. Transition blocks take the
    shortcut through the normalised pre-activation. ``train`` is
    ignored."""

    def __init__(self, cin: int, features: int, stride: int, alpha: float,
                 beta: float, dtype: torch.dtype):
        super().__init__()
        f = features
        self.alpha, self.beta, self.dtype = alpha, beta, dtype
        self.needs_proj = stride != 1 or cin != 4 * f
        if self.needs_proj:
            self.conv_proj = WSConv(cin, 4 * f, 1, stride, dtype)
        self.conv1 = WSConv(cin, f, 1, 1, dtype)
        self.conv2 = WSConv(f, f, 3, stride, dtype)
        self.conv3 = WSConv(f, 4 * f, 1, 1, dtype)
        self.skip_gain = _param(())

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        y = (torch.relu(x.float()) * (GAMMA_RELU / self.beta)).to(dt)
        shortcut = self.conv_proj(y) if self.needs_proj else x
        z = (torch.relu(self.conv1(y).float()) * GAMMA_RELU).to(dt)
        z = (torch.relu(self.conv2(z).float()) * GAMMA_RELU).to(dt)
        z = self.conv3(z)
        out = shortcut.float() + self.alpha * self.skip_gain * z.float()
        return out.to(dt)


class FusedBottleneckBlock(nn.Module):
    """``norm_variant="fused"`` and ``"fused3"`` (``resnet.py:228-413``):
    the 1x1 convs are :func:`norm_relu_matmul` (K4f forward, K4dx and
    K4dw backward) with BatchNorm statistics from the kernel's epilogue;
    conv3 and the residual read raw conv outputs and fold the norm in.
    With ``pallas_conv3`` (``fused3``; the JAX field's name) a stride-1
    block's 3x3 conv is :func:`conv3_norm_stats` (K5f forward, K5dx and
    K5dw backward): it reads conv1's raw output, applies norm1 + relu as
    it reads it, and norm2's statistics come from its epilogue
    (``:355-373``). Otherwise
    (and in stride-2 blocks) the 3x3 conv is ``F.conv2d`` on the
    materialised relu(norm1), with norm2's moments from one f32
    reduction, as the JAX block's XLA branch has it (``:374-394``)."""

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype, use_kernels: bool = True,
                 pallas_conv3: bool = False):
        super().__init__()
        f = features
        self.stride, self.dtype, self.use_kernels = stride, dtype, use_kernels
        self.fused_3x3 = pallas_conv3 and stride == 1
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
        k2 = self.conv2_kernel.to(dt)
        y1 = y1.reshape(bsz, h, w_, f)
        if self.fused_3x3:
            # K5 reads raw y1 (norm1 + relu applied as it reads) and sums
            # its rounded output for norm2
            conv = (conv3_norm_stats if self.use_kernels
                    else conv3_norm_stats_plain)
            moments = None
            if train:
                y2, s2, ss2 = conv(y1, k2, a1, b1, relu=True, want_stats=True)
                moments = stats_to_moments(s2, ss2, bsz * h * w_)
            else:
                y2 = conv(y1, k2, a1, b1, relu=True)
        else:
            # norm1 + relu materialise for the 3x3 conv
            n1 = torch.relu(y1.float() * a1 + b1).to(dt)
            y2 = conv_nhwc(n1, k2, s).contiguous()
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
    """``ResNet(stage_sizes, num_classes, num_filters, dtype, s2d_stem,
    norm_variant)`` as the JAX module, on ``device`` (default ``cuda``;
    pass ``cpu`` for the plain versions), with weights from ``seed``.
    ``forward(x [B, H, W, 3], train)`` returns f32 logits; ``nf`` ignores
    ``train``."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64,
                 dtype: Optional[torch.dtype] = torch.bfloat16,
                 s2d_stem: bool = False, norm_variant: str = "bn",
                 use_kernels: bool = True,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        if norm_variant not in VARIANTS:
            raise ValueError(f"norm_variant must be {'|'.join(VARIANTS)}, "
                             f"got {norm_variant!r}")
        device = resolve_device(device)
        dt = dtype or torch.float32
        self.dtype, self.s2d_stem = dt, s2d_stem
        self.nf = norm_variant == "nf"
        stem = WSConv if self.nf else Conv
        if s2d_stem:  # 2x2 space-to-depth: 12 channels, 4x4 stride 1
            self.conv_init_s2d = stem(12, num_filters, 4, 1, dt)
        else:
            self.conv_init = stem(3, num_filters, 7, 2, dt,
                                  padding=((3, 3), (3, 3)))
        if not self.nf:
            self.bn_init = make_norm(norm_variant, num_filters, dt)
        self.block_names = []
        cin = num_filters
        expected_var = 1.0  # nf: the analytic variance entering each block
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                f = num_filters * 2 ** i
                if self.nf:
                    block = NFBottleneckBlock(cin, f, stride, NF_ALPHA,
                                              expected_var ** 0.5, dt)
                    # a transition's shortcut took the normalised input
                    expected_var = (1.0 if j == 0 else expected_var
                                    ) + NF_ALPHA ** 2
                elif norm_variant in ("fused", "fused3"):
                    block = FusedBottleneckBlock(
                        cin, f, stride, dt, use_kernels,
                        pallas_conv3=norm_variant == "fused3")
                else:
                    block = BottleneckBlock(cin, f, stride, dt, norm_variant)
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
        x = x.to(self.dtype)
        if self.s2d_stem:
            x = self.conv_init_s2d(space_to_depth(x, 2))
        else:
            x = self.conv_init(x)
        if self.nf:
            x = (torch.relu(x.float()) * GAMMA_RELU).to(self.dtype)
        else:
            x = torch.relu(self.bn_init(x, train))
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        if self.nf:
            x = torch.relu(x.float()).to(self.dtype)
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
