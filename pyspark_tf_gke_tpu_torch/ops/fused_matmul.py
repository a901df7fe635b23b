"""Fused 1x1-conv matmul with a BatchNorm input transform and statistics
epilogue (K4f forward, K4dx and K4dw backward), differentiable.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py``. A
bottleneck block's 1x1 convs are matmuls over NHWC rows, ``[B*H*W, Cin]
@ [Cin, Cout]``; :func:`norm_relu_matmul` computes

    y = relu(x * a + b) @ w      (the transform and relu are optional)

with ``a = scale * rsqrt(var + eps)`` and ``b = bias - mean * a`` folded
from the producer's BatchNorm (:func:`bn_fold`), and optionally the f32
per-column ``sum`` and ``sumsq`` of the rounded ``y`` — the consumer
BatchNorm's statistics (:func:`stats_to_moments`). It is a
``torch.autograd.Function``: the forward is the K4f kernel and the
backward is K4dx (``dx`` with the relu mask, and ``d a``, ``d b``) plus
K4dw (``dw``), all in ``csrc/fused_matmul.cu``. Each chooses its design
by dtype: bf16 runs the tensor-core kernels (``wgmma`` over TMA-filled
swizzled tiles; K4f and K4dx on persistent CTAs with a producer
warpgroup, K4dw on ``csrc/wgmma_dw.cuh``, shared with K5dw), f32 the CUDA-core
kernels; :func:`k4_plan` gives K4f's and K4dx's tile, :func:`dw_plan`
K4dw's tile and split of the rows. The BatchNorm chain
around it (moments from the sums, the fold) is plain PyTorch that
autograd differentiates, as JAX differentiates it around the
``custom_vjp``.

Rounding points (``:106-109``, ``:127``, ``:329-350``): the transformed
input is rounded to ``x``'s dtype before the product; products
accumulate in f32; ``y`` is in ``x``'s dtype and the statistics are sums
of the rounded ``y``. In the backward the output cotangent ``gy + gs +
2*y*gss`` is formed in f32 and rounded to ``y``'s dtype before both
kernels; ``dx`` is in ``x``'s dtype, ``d a`` and ``d b`` in f32, and
``dw`` in ``dy``'s dtype, then cast to ``w``'s.

The ``*_plain`` functions are the same computations in plain PyTorch (f32
products). The wrappers take them only for tensors that lie on the CPU;
a CUDA tensor launches the kernel or raises. :func:`norm_relu_matmul_plain`
is the differentiable op through the plain versions on any device.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

BLOCK_M = 128  # output tile of the CUDA-core K4 kernels (tile_gemm.cuh kBM, kBN)
BLOCK_N = 64
BLOCK_K = 16   # reduction step; f32 K4dw's M splits are multiples of it

# bf16 K4f and K4dx, the tensor-core kernels (fused_matmul.cu wg::): a
# CTA tile of K4_BLOCK_M rows (two warpgroups of 64) by 64 output
# columns where the output is at most 64 wide, else 128; persistent
# CTAs, one an SM, walk the tiles
K4_BLOCK_M = 128
K4_BLOCK_N = (64, 128)
DW_TARGET_BLOCKS = 528  # f32 K4dw: split M until ~4 blocks per SM of an H100
DW_MIN_ROWS = 256  # ... but give each split at least this many rows

# bf16 K4dw and K5dw, the tensor-core kernels (csrc/wgmma_dw.cuh): a
# warpgroup owns a DW_WG_TILE x DW_WG_TILE tile of dw and reduces
# DW_STEP rows (pixels) a step. K4dw's CTA is 1 or 2 such tiles along
# K and along N (64 wide where K or N is at most 64); K5dw's is one tile
# at the three taps of a kernel row (three warpgroups).
DW_WG_TILE = 64
DW_STEP = 64
DW_SMS = 132  # the plan sizes its waves for an H100's SMs
# CTAs an SM holds, by warpgroups a CTA: what the 4-slot ring's shared
# memory (16, 24, 32 KB a slot) and 128 registers a thread allow (the
# kernels' launch bounds: fused_matmul.cu wgdw::kResident1, 2, 4)
DW_RESIDENT = {1: 3, 2: 2, 3: 1, 4: 1}
DW_MIN_STEPS = 8  # steps a split reduces at least (the ring's fill and drain)

fwd_launches = 0  # K4f launches since the last reset (chip_smoke reads them)
dx_launches = 0   # K4dx
dw_launches = 0   # K4dw

Stats = Optional[torch.Tensor]  # [2, C] f32: per-column sum and sumsq


# -- BatchNorm helpers (``fused_matmul.py:379-395``) --------------------------


def bn_fold(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN parameters and statistics into the per-channel affine
    ``(a, b)`` the kernels take: ``norm(x) = x*a + b``."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b


def stats_to_moments(s: torch.Tensor, ss: torch.Tensor,
                     count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq, N) -> (mean, biased variance clamped at 0), flax
    BatchNorm's convention (``mean(x^2) - mean(x)^2``)."""
    mean = s / count
    var = torch.clamp_min(ss / count - mean * mean, 0.0)
    return mean, var


# -- plain versions -----------------------------------------------------------


def _transform(x: torch.Tensor, a: Optional[torch.Tensor],
               b: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """``relu(x*a + b)`` in f32, rounded to x's dtype (x when a is None)."""
    if a is None:
        return x
    t = x.float() * a + b
    if relu:
        t = torch.relu(t)
    return t.to(x.dtype)


def _fwd_plain(x, w, a, b, relu: bool, want_stats: bool
               ) -> Tuple[torch.Tensor, Stats]:
    y = (_transform(x, a, b, relu).float() @ w.float()).to(x.dtype)
    if not want_stats:
        return y, None
    yr = y.float()
    return y, torch.stack([yr.sum(0), (yr * yr).sum(0)])


def norm_relu_matmul_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                              x: torch.Tensor, a: Optional[torch.Tensor],
                              b: Optional[torch.Tensor], relu: bool
                              ) -> Tuple[torch.Tensor, Stats]:
    """``(dx, [d a; d b])`` for the output cotangent ``dy`` (K4dx);
    the second is None without a transform."""
    return dx_epilogue(dy.float() @ w.float().t(), x, a, b, relu)


def dx_epilogue(u: torch.Tensor, x: torch.Tensor, a: Optional[torch.Tensor],
                b: Optional[torch.Tensor], relu: bool
                ) -> Tuple[torch.Tensor, Stats]:
    """From ``u``, the f32 gradient of the transformed input ``[M, K]``
    (``x`` is ``[M, K]`` too): ``dx = u*a`` (``u`` masked where ``x*a + b
    <= 0`` with relu) in x's dtype, and the per-column ``[sum(u*x);
    sum(u)]`` (d a, d b); ``(u, None)`` without a transform."""
    if a is None:
        return u.to(x.dtype), None
    xf = x.float()
    if relu:
        u = torch.where(xf * a + b > 0, u, torch.zeros_like(u))
    return (u * a).to(x.dtype), torch.stack([(u * xf).sum(0), u.sum(0)])


def norm_relu_matmul_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                              a: Optional[torch.Tensor],
                              b: Optional[torch.Tensor], relu: bool
                              ) -> torch.Tensor:
    """``dw = relu(x*a + b)^T @ dy`` in dy's dtype (K4dw)."""
    xn = _transform(x, a, b, relu)
    return (xn.float().t() @ dy.float()).to(dy.dtype)


# -- kernel wrappers ----------------------------------------------------------


def _check_pair(a, b) -> None:
    if (a is None) != (b is None):
        raise ValueError("a and b must be provided together")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _transform_code(a, relu: bool) -> int:
    return 0 if a is None else (2 if relu else 1)


def _check(kernel: str, operands, a, b, kdim: int) -> Tuple[torch.device, int]:
    """Device, contiguity and dtypes of a K4 call; returns the device and
    the dtype code. ``operands`` are the [rows, cols] matrices, all of one
    float dtype; ``a`` and ``b`` are f32 ``[kdim]`` or both None."""
    _check_pair(a, b)
    extra = () if a is None else (a, b)
    device = kernels.require_cuda(kernel, *operands, *extra)
    dtype = operands[0].dtype
    code = kernels.dtype_code(dtype, kernel)
    if code == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError(f"{kernel} kernel takes float operands")
    for t in operands:
        if t.dtype != dtype or t.dim() != 2:
            raise ValueError(f"{kernel} kernel takes 2-D operands of one "
                             f"dtype, got {t.dtype} {tuple(t.shape)} beside "
                             f"{dtype}")
    for t in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != (kdim,):
            raise ValueError(f"{kernel} kernel takes float32 a and b "
                             f"[{kdim}], got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (*operands, *extra)):
        raise ValueError(f"{kernel} kernel takes contiguous tensors")
    return device, code


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def k4_plan(m: int, kdim: int, n: int, dtype: torch.dtype
            ) -> Tuple[int, int, int, int]:
    """The output tiles of K4f's product ``[m, kdim] @ [kdim, n]`` (and of
    K4dx's ``dy [m, n] @ w^T``, as ``k4_plan(m, n, kdim, dtype)``):
    ``(block_m, block_n, tiles_m, tiles_n)``; the statistics partials
    are ``[tiles_m, 2, n]``. bf16 runs the tensor-core kernel
    (:data:`K4_BLOCK_M` rows, 64 columns up to ``n = 64`` and 128
    beyond), f32 the CUDA-core kernel (:data:`BLOCK_M` x
    :data:`BLOCK_N`). A function of the shape and dtype alone, so the
    order of summation (and the result) does not depend on the card."""
    if dtype != torch.bfloat16:
        bm, bn = BLOCK_M, BLOCK_N
    else:
        bm, bn = K4_BLOCK_M, K4_BLOCK_N[0 if n <= K4_BLOCK_N[0] else 1]
    return bm, bn, _cdiv(m, bm), _cdiv(n, bn)


def norm_relu_matmul_fwd(x: torch.Tensor, w: torch.Tensor,
                         a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                         relu: bool, want_stats: bool
                         ) -> Tuple[torch.Tensor, Stats]:
    """K4f: ``(y, [sum; sumsq] or None)`` (no autograd)."""
    global fwd_launches
    if x.device.type == "cpu":
        return _fwd_plain(x, w, a, b, relu, want_stats)
    m, kdim = x.shape
    device, code = _check("k4_fwd", (x, w), a, b, kdim)
    n = w.shape[1]
    if w.shape[0] != kdim:
        raise ValueError(f"k4_fwd: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    y = torch.empty((m, n), dtype=x.dtype, device=device)
    # the kernel writes every column of the statistics
    stats = (torch.empty((2, n), dtype=torch.float32, device=device)
             if want_stats else None)
    if m == 0 or n == 0 or kdim == 0:  # an empty product: all zero
        return y.zero_(), None if stats is None else stats.zero_()
    _, block_n, tiles_m, _ = k4_plan(m, kdim, n, x.dtype)
    part = (torch.empty((tiles_m, 2, n), dtype=torch.float32, device=device)
            if want_stats else None)
    rc = kernels.library().port_k4_fwd(
        x.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
        _ptr(part), _ptr(stats), m, kdim, n, _transform_code(a, relu),
        int(want_stats), block_n, code,
        *kernels.launch_args(device))
    kernels.check(rc, "k4_fwd")
    fwd_launches += 1
    return y, stats


def norm_relu_matmul_dx(dy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                        a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                        relu: bool) -> Tuple[torch.Tensor, Stats]:
    """K4dx: ``(dx, [d a; d b] or None)``."""
    global dx_launches
    if x.device.type == "cpu":
        return norm_relu_matmul_dx_plain(dy, w, x, a, b, relu)
    m, kdim = x.shape
    device, code = _check("k4_dx", (dy, w, x), a, b, kdim)
    n = dy.shape[1]
    if dy.shape[0] != m or tuple(w.shape) != (kdim, n):
        raise ValueError(f"k4_dx: dy {tuple(dy.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    # the kernel writes every column of d a, d b
    dstats = (torch.empty((2, kdim), dtype=torch.float32, device=device)
              if a is not None else None)
    if m == 0 or kdim == 0 or n == 0:  # an empty product: all zero
        return dx.zero_(), None if dstats is None else dstats.zero_()
    _, block_n, tiles_m, _ = k4_plan(m, n, kdim, x.dtype)
    part = (torch.empty((tiles_m, 2, kdim), dtype=torch.float32,
                        device=device) if a is not None else None)
    rc = kernels.library().port_k4_dx(
        dy.data_ptr(), w.data_ptr(), x.data_ptr(), _ptr(a), _ptr(b),
        dx.data_ptr(), _ptr(part), _ptr(dstats), m, kdim, n,
        _transform_code(a, relu), block_n, code,
        *kernels.launch_args(device))
    kernels.check(rc, "k4_dx")
    dx_launches += 1
    return dx, dstats


def dw_splits(m: int, kdim: int, n: int, taps: int = 1) -> Tuple[int, int]:
    """f32 K4dw's split of the M rows across blocks (and f32 K5dw's,
    whose grid has ``taps = 9`` times the K x N tiles): ``(splits,
    chunk)`` with ``chunk`` a multiple of :data:`BLOCK_K` and every split
    non-empty. A function of the shape alone, so the summation order (and
    the result) does not depend on the card."""
    tiles = taps * _cdiv(kdim, BLOCK_M) * _cdiv(n, BLOCK_N)
    want = max(1, min(_cdiv(DW_TARGET_BLOCKS, tiles), m // DW_MIN_ROWS,
                      65535 // taps))
    chunk = _cdiv(_cdiv(m, want), BLOCK_K) * BLOCK_K
    return _cdiv(m, chunk), chunk


@functools.lru_cache(maxsize=None)
def dw_plan(m: int, kdim: int, n: int, dtype: torch.dtype,
            taps: int = 1) -> Tuple[int, int, int, int]:
    """K4dw's (``taps=1``) or K5dw's (``taps=9``) plan: ``(tile_k,
    tile_n, splits, chunk)``, a CTA's dw tile and the split of the M rows
    (pixels) into ``splits`` runs of ``chunk``, every one non-empty; the
    f32 partials are ``[splits, taps, K, N]``. f32 runs the CUDA-core
    kernels (:data:`BLOCK_M` x :data:`BLOCK_N` tiles, :func:`dw_splits`);
    bf16 the tensor-core ones, whose chunk is a whole number of
    :data:`DW_STEP` steps and whose split count makes the fewest
    step-times over the waves of :data:`DW_SMS` SMs; bf16 K4dw launches
    its kernel at this tile, K5dw's is 64 x 64 at each tap. A function
    of the shape and dtype alone, so the summation order (and the
    result) does not depend on the card."""
    if dtype != torch.bfloat16:
        return (BLOCK_M, BLOCK_N) + dw_splits(m, kdim, n, taps)
    t = DW_WG_TILE
    if taps == 1:
        tk, tn = (2 * t if kdim > t else t), (2 * t if n > t else t)
        wgs = (tk // t) * (tn // t)
        tiles = _cdiv(kdim, tk) * _cdiv(n, tn)
    else:  # the three taps of a kernel row, a warpgroup each
        tk = tn = t
        wgs = 3
        tiles = 3 * _cdiv(kdim, t) * _cdiv(n, t)
    wave = DW_SMS * DW_RESIDENT[wgs]
    steps = _cdiv(m, DW_STEP)
    best_cost, best_steps = None, steps
    for splits in range(1, max(1, steps // DW_MIN_STEPS) + 1):
        per = _cdiv(steps, splits)
        cost = _cdiv(tiles * splits, wave) * per
        if best_cost is None or cost < best_cost:
            best_cost, best_steps = cost, per
    chunk = best_steps * DW_STEP
    return tk, tn, _cdiv(m, chunk), chunk


def norm_relu_matmul_dw(x: torch.Tensor, dy: torch.Tensor,
                        a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                        relu: bool) -> torch.Tensor:
    """K4dw: ``dw [K, N]`` in dy's dtype, reduced in f32 over the
    :func:`dw_plan` splits of the rows."""
    global dw_launches
    if x.device.type == "cpu":
        return norm_relu_matmul_dw_plain(x, dy, a, b, relu)
    m, kdim = x.shape
    device, code = _check("k4_dw", (x, dy), a, b, kdim)
    n = dy.shape[1]
    if dy.shape[0] != m:
        raise ValueError(f"k4_dw: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    dw = torch.empty((kdim, n), dtype=dy.dtype, device=device)
    if kdim == 0 or n == 0:
        return dw
    if m == 0:
        return dw.zero_()
    tk, tn, splits, chunk = dw_plan(m, kdim, n, dy.dtype)
    part = torch.empty((splits, kdim, n), dtype=torch.float32, device=device)
    rc = kernels.library().port_k4_dw(
        x.data_ptr(), dy.data_ptr(), _ptr(a), _ptr(b), part.data_ptr(),
        dw.data_ptr(), m, kdim, n, _transform_code(a, relu), splits, chunk,
        tk // DW_WG_TILE, tn // DW_WG_TILE, code,
        *kernels.launch_args(device))
    kernels.check(rc, "k4_dw")
    dw_launches += 1
    return dw


# -- the differentiable op ----------------------------------------------------


class FusedNormOp(torch.autograd.Function):
    """The differentiable op of the fused conv+BN kernels: K4 here, K5 in
    ``ops/fused_conv3.py``. ``apply(x, w, a, b, relu, want_stats, fns)``
    with ``fns = (fwd, dx, dw)``, the op's three kernel wrappers (or
    their plain versions): ``fwd(x, w, a, b, relu, want_stats) -> (y,
    [sum; sumsq] or None)``, ``dx(dy, w, x, a, b, relu) -> (dx, [d a; d
    b] or None)`` and ``dw(x, dy, a, b, relu) -> dw``. The statistics
    run over every axis of ``y`` but the last (the channels)."""

    @staticmethod
    def forward(ctx, x, w, a, b, relu, want_stats, fns):
        fwd, ctx.dx_fn, ctx.dw_fn = fns
        y, stats = fwd(x, w, a, b, relu, want_stats)
        ctx.save_for_backward(x, w, a, b, y)
        ctx.relu = relu
        ctx.set_materialize_grads(False)
        return (y, stats[0], stats[1]) if want_stats else y

    @staticmethod
    def backward(ctx, gy, gs=None, gss=None):
        x, w, a, b, y = ctx.saved_tensors
        if gs is None and gss is None:
            dy = gy if gy is not None else torch.zeros_like(y)
        else:
            # the statistics' cotangent: d sum -> +gs per channel, d sumsq
            # -> +2*y*gss; formed in f32, rounded to y's dtype
            d = gy.float() if gy is not None else torch.zeros(
                y.shape, dtype=torch.float32, device=y.device)
            if gs is not None:
                d = d + gs
            if gss is not None:
                d = d + 2.0 * y.float() * gss
            dy = d.to(y.dtype)
        dy = dy.contiguous()
        dx = da = db = dw = None
        need_x, need_w, need_a, need_b = ctx.needs_input_grad[:4]
        if need_x or (a is not None and (need_a or need_b)):
            dx, dstats = ctx.dx_fn(dy, w, x, a, b, ctx.relu)
            if a is not None:
                da, db = dstats[0], dstats[1]
        if need_w:
            dw = ctx.dw_fn(x, dy, a, b, ctx.relu).to(w.dtype)
        return dx, dw, da, db, None, None, None


def norm_relu_matmul(x: torch.Tensor, w: torch.Tensor,
                     a: Optional[torch.Tensor] = None,
                     b: Optional[torch.Tensor] = None, *,
                     relu: bool = True, want_stats: bool = False):
    """``relu(x*a + b) @ w`` for ``x [M, K]`` and ``w [K, N]`` of one
    float dtype, with f32 ``a`` and ``b [K]`` (both None: no transform,
    and no relu). Returns ``y [M, N]`` in x's dtype, or ``(y, sum,
    sumsq)`` with ``want_stats``: f32 per-column reductions of the
    rounded ``y``. Differentiable in ``x``, ``w``, ``a`` and ``b``."""
    _check_pair(a, b)
    return FusedNormOp.apply(x, w, a, b, relu and a is not None, want_stats,
                             (norm_relu_matmul_fwd, norm_relu_matmul_dx,
                              norm_relu_matmul_dw))


def norm_relu_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                           a: Optional[torch.Tensor] = None,
                           b: Optional[torch.Tensor] = None, *,
                           relu: bool = True, want_stats: bool = False):
    """:func:`norm_relu_matmul` through the plain versions on any device
    (the models' ``use_kernels=False``): K4f's plain version forward,
    K4dx's and K4dw's as the backward, so it rounds at the kernels'
    points and differs from them only by the order of f32 sums."""
    _check_pair(a, b)
    return FusedNormOp.apply(x, w, a, b, relu and a is not None, want_stats,
                             (_fwd_plain, norm_relu_matmul_dx_plain,
                              norm_relu_matmul_dw_plain))
