"""Fused 3x3 conv (stride 1, SAME) with a BatchNorm input transform and
statistics epilogue (K5f forward, K5dx and K5dw backward), differentiable.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py``. For
``x [B, H, W, K]`` (NHWC, the RAW output of the producer conv) and ``w
[3, 3, K, N]`` (HWIO), :func:`conv3_norm_stats` computes

    y = conv3x3_same(relu(x * a + b), w)      (transform and relu optional)

and optionally the f32 per-channel ``sum`` and ``sumsq`` of the rounded
``y`` — the next BatchNorm's statistics. The SAME padding is zero AFTER
the transform (XLA pads the normalised input; ``relu(b)`` is not 0). It
runs through :class:`~pyspark_tf_gke_tpu_torch.ops.fused_matmul.FusedNormOp`,
the autograd Function K4 uses: the forward is the K5f kernel and the
backward is K5dx (``dx`` with the relu mask, and ``d a``, ``d b``) plus
K5dw (``dw``), all in ``csrc/fused_conv3.cu``.

Each chooses its design by dtype: bf16 runs the tensor-core kernels
(``wgmma`` over swizzled shared-memory tiles; K5f the transform applied
in shared memory and each tap's products summed in f32 in tap order;
K5dx K4dx's persistent design with the tap-shifted dy brought as one 4-D
TMA box of whole image rows, whose out-of-bounds zeros are the padding;
K5dw the tap shift moved onto dy and x transformed once a kernel row, on
K4dw's mainloop ``csrc/wgmma_dw.cuh``), f32 the CUDA-core kernels. Both
round at the same points; :func:`k5f_plan`, :func:`k5dx_plan` and
``fused_matmul.dw_plan`` give each one's tile.

Rounding points (``:43-52``, ``:62-72``, ``:243-257``): the transformed
input is rounded to x's dtype before the products; each output is the
sum of the nine tap products, accumulated in f32 and rounded once; the
statistics are sums of the rounded ``y``. In the backward the output
cotangent ``gy + gs + 2*y*gss`` is formed in f32 and rounded to y's
dtype before both kernels; ``dx`` is in x's dtype, ``d a`` and ``d b`` in
f32, ``dw`` summed in f32 and rounded to w's dtype. The relu mask is
``x*a + b > 0`` on the f32 value.

The ``*_plain`` functions are the same computations in plain PyTorch:
nine shifted ``[pixels, K] @ [K, N]`` products of f32-upcast operands
through ``torch.matmul``, which runs in full f32 on the card unless
``torch.backends.cuda.matmul.allow_tf32`` is set (``chip_smoke.py``
turns TF32 off for matmuls and cuDNN alike). The wrappers take them only
for tensors that lie on the CPU; a CUDA tensor launches the kernel or
raises.
:func:`conv3_norm_stats_plain` is the differentiable op through the
plain versions on any device (the model's ``use_kernels=False``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu_torch.ops import kernels
from pyspark_tf_gke_tpu_torch.ops.fused_matmul import (BLOCK_M, FusedNormOp,
                                                       Stats, _cdiv,
                                                       _check_pair, _ptr,
                                                       _transform,
                                                       _transform_code,
                                                       dw_plan, dx_epilogue)

TAPS = 9
# K5f's CTA tiles, (pixels, output channels), kept in step with
# csrc/fused_conv3.cu: the bf16 tensor-core kernel takes wg::kBM x kBN
# for N <= 64 and wg::kWideBM x kWideBN beyond; the f32 CUDA-core kernel
# takes tile_gemm.cuh's kBM x kBN (the narrow tile). One row of
# statistics partials per pixel tile.
K5F_TILE = (128, 64)
K5F_WIDE_TILE = (64, 128)
# K5dx's pixel tiles: the bf16 tensor-core kernel (csrc/fused_conv3.cu
# wgdx::) takes the tile k5dx_plan gives it, whole image rows of at most
# K5DX_PIXELS pixels (wgdx::kBM); the f32 CUDA-core kernel takes
# fused_matmul.BLOCK_M flattened pixels. One row of d a / d b partials
# per pixel tile.
K5DX_PIXELS = 128

fwd_launches = 0  # K5f launches since the last reset (chip_smoke reads them)
dx_launches = 0   # K5dx
dw_launches = 0   # K5dw


# -- plain versions -----------------------------------------------------------


def _windows(t: torch.Tensor, flip: bool) -> Iterator[Tuple[int, int,
                                                             torch.Tensor]]:
    """``(dh, dw, window)`` for the nine taps in order: ``window [B*H*W,
    C]`` holds ``t[b, i+dh-1, j+dw-1]`` (``flip``: ``t[b, i-dh+1,
    j-dw+1]``, the adjoint's taps), zero outside the image."""
    bsz, h, wd, c = t.shape
    padded = F.pad(t, (0, 0, 1, 1, 1, 1))
    for dh in range(3):
        for dw in range(3):
            oh, ow = (2 - dh, 2 - dw) if flip else (dh, dw)
            yield dh, dw, padded[:, oh:oh + h, ow:ow + wd, :].reshape(-1, c)


def conv3_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                    a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                    relu: bool, want_stats: bool
                    ) -> Tuple[torch.Tensor, Stats]:
    """K5f's plain version: ``(y, [sum; sumsq] or None)``."""
    bsz, h, wd, _ = x.shape
    wf = w.float()
    acc = None
    for dh, dw, win in _windows(_transform(x, a, b, relu).float(), False):
        prod = win @ wf[dh, dw]
        acc = prod if acc is None else acc + prod
    y = acc.to(x.dtype)
    stats = None
    if want_stats:
        yr = y.float()
        stats = torch.stack([yr.sum(0), (yr * yr).sum(0)])
    return y.reshape(bsz, h, wd, -1), stats


def conv3_dx_plain(dy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                   a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                   relu: bool) -> Tuple[torch.Tensor, Stats]:
    """K5dx's plain version: ``(dx, [d a; d b] or None)``."""
    wf = w.float()
    u = None
    for dh, dw, win in _windows(dy.float(), True):
        prod = win @ wf[dh, dw].t()
        u = prod if u is None else u + prod
    dx, dstats = dx_epilogue(u, x.reshape(-1, x.shape[-1]), a, b, relu)
    return dx.reshape(x.shape), dstats


def conv3_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                   a: Optional[torch.Tensor], b: Optional[torch.Tensor],
                   relu: bool) -> torch.Tensor:
    """K5dw's plain version: ``dw [3, 3, K, N]`` in dy's dtype."""
    k, n = x.shape[-1], dy.shape[-1]
    dyf = dy.float().reshape(-1, n)
    xn = _transform(x, a, b, relu).float()
    dw = torch.stack([win.t() @ dyf for _, _, win in _windows(xn, False)])
    return dw.reshape(3, 3, k, n).to(dy.dtype)


# -- kernel wrappers ----------------------------------------------------------


def k5f_plan(m: int, n: int, dtype: torch.dtype
             ) -> Tuple[int, int, int, int]:
    """K5f's tile and grid for M pixels and N output channels:
    ``(block_m, block_n, pixel tiles, channel tiles)``; the statistics
    partials are ``[pixel tiles, 2, N]``."""
    wide = dtype == torch.bfloat16 and n > K5F_TILE[1]
    bm, bn = K5F_WIDE_TILE if wide else K5F_TILE
    return bm, bn, _cdiv(m, bm), _cdiv(n, bn)


def k5dx_plan(bsz: int, h: int, wd: int, dtype: torch.dtype
              ) -> Tuple[Tuple[int, int, int], int]:
    """K5dx's pixel tile and the number of pixel tiles (the rows of the
    d a / d b partials ``[tiles, 2, K]``) for ``x [bsz, h, wd, K]``.
    bf16: ``(nb, rows, wc)`` = nb images of ``rows`` whole image rows of
    ``wc`` columns (at most K5DX_PIXELS pixels), so that one 4-D TMA box
    brings a tap-shifted tile with its zero padding; the kernel takes
    this tile. f32: 128 flattened pixels, ``(1, 1, BLOCK_M)``."""
    if dtype != torch.bfloat16:
        return (1, 1, BLOCK_M), _cdiv(bsz * h * wd, BLOCK_M)
    wc = min(wd, K5DX_PIXELS)
    rows = 1 if wc < wd else min(h, K5DX_PIXELS // wd)
    nb = 1 if (rows < h or wc < wd) else min(bsz, K5DX_PIXELS // (h * wd))
    return (nb, rows, wc), _cdiv(bsz, nb) * _cdiv(h, rows) * _cdiv(wd, wc)


def _check(kernel: str, x, w, dy, a, b) -> Tuple[torch.device, int]:
    """Device, dtypes, shapes and contiguity of a K5 call; returns the
    device and the dtype code. ``x [B, H, W, K]``, ``w [3, 3, K, N]`` and
    ``dy [B, H, W, N]`` (either may be None) of one float dtype; ``a`` and
    ``b`` are f32 ``[K]`` or both None."""
    _check_pair(a, b)
    ops = [t for t in (x, w, dy) if t is not None]
    extra = () if a is None else (a, b)
    device = kernels.require_cuda(kernel, *ops, *extra)
    code = kernels.dtype_code(x.dtype, kernel)
    if code == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError(f"{kernel} kernel takes float operands")
    shapes = " ".join(f"{t.dtype} {tuple(t.shape)}" for t in ops)
    ok = x.dim() == 4 and all(t.dtype == x.dtype for t in ops)
    if ok and w is not None:
        ok = w.dim() == 4 and tuple(w.shape[:3]) == (3, 3, x.shape[3])
    if ok and dy is not None:
        ok = (dy.dim() == 4 and dy.shape[:3] == x.shape[:3]
              and (w is None or dy.shape[3] == w.shape[3]))
    if not ok:
        raise ValueError(f"{kernel} kernel takes x [B, H, W, K], w [3, 3, "
                         f"K, N] and dy [B, H, W, N] of one dtype, got "
                         f"{shapes}")
    for t in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[3],):
            raise ValueError(f"{kernel} kernel takes float32 a and b "
                             f"[{x.shape[3]}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in (*ops, *extra)):
        raise ValueError(f"{kernel} kernel takes contiguous tensors")
    return device, code


def conv3_fwd(x: torch.Tensor, w: torch.Tensor, a: Optional[torch.Tensor],
              b: Optional[torch.Tensor], relu: bool, want_stats: bool
              ) -> Tuple[torch.Tensor, Stats]:
    """K5f: ``(y, [sum; sumsq] or None)`` (no autograd)."""
    global fwd_launches
    if x.device.type == "cpu":
        return conv3_fwd_plain(x, w, a, b, relu, want_stats)
    device, code = _check("k5_fwd", x, w, None, a, b)
    bsz, h, wd, kdim = x.shape
    n = w.shape[3]
    m = bsz * h * wd
    y = torch.empty((bsz, h, wd, n), dtype=x.dtype, device=device)
    stats = (torch.zeros((2, n), dtype=torch.float32, device=device)
             if want_stats else None)
    if m == 0 or n == 0:
        return y, stats
    if kdim == 0:  # an empty product: y and its statistics are zero
        return y.zero_(), stats
    tiles = k5f_plan(m, n, x.dtype)[2]
    part = (torch.empty((tiles, 2, n), dtype=torch.float32, device=device)
            if want_stats else None)
    rc = kernels.library().port_k5_fwd(
        x.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
        _ptr(part), _ptr(stats), bsz, h, wd, kdim, n,
        _transform_code(a, relu), int(want_stats), code,
        *kernels.launch_args(device))
    kernels.check(rc, "k5_fwd")
    fwd_launches += 1
    return y, stats


def conv3_dx(dy: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
             a: Optional[torch.Tensor], b: Optional[torch.Tensor],
             relu: bool) -> Tuple[torch.Tensor, Stats]:
    """K5dx: ``(dx, [d a; d b] or None)``."""
    global dx_launches
    if x.device.type == "cpu":
        return conv3_dx_plain(dy, w, x, a, b, relu)
    device, code = _check("k5_dx", x, w, dy, a, b)
    bsz, h, wd, kdim = x.shape
    n = w.shape[3]
    dx = torch.empty_like(x)
    dstats = (torch.zeros((2, kdim), dtype=torch.float32, device=device)
              if a is not None else None)
    m = bsz * h * wd
    if m == 0 or kdim == 0:
        return dx, dstats
    if n == 0:
        return dx.zero_(), dstats
    tile, tiles = k5dx_plan(bsz, h, wd, x.dtype)
    part = (torch.empty((tiles, 2, kdim), dtype=torch.float32,
                        device=device) if a is not None else None)
    rc = kernels.library().port_k5_dx(
        dy.data_ptr(), w.data_ptr(), x.data_ptr(), _ptr(a), _ptr(b),
        dx.data_ptr(), _ptr(part), _ptr(dstats), bsz, h, wd, kdim, n,
        _transform_code(a, relu), *tile, code, *kernels.launch_args(device))
    kernels.check(rc, "k5_dx")
    dx_launches += 1
    return dx, dstats


def conv3_dw(x: torch.Tensor, dy: torch.Tensor, a: Optional[torch.Tensor],
             b: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """K5dw: ``dw [3, 3, K, N]`` in dy's dtype, reduced in f32 over the
    ``fused_matmul.dw_plan`` (``taps=9``) splits of the pixels."""
    global dw_launches
    if x.device.type == "cpu":
        return conv3_dw_plain(x, dy, a, b, relu)
    device, code = _check("k5_dw", x, None, dy, a, b)
    bsz, h, wd, kdim = x.shape
    n = dy.shape[3]
    dw = torch.empty((3, 3, kdim, n), dtype=dy.dtype, device=device)
    m = bsz * h * wd
    if kdim == 0 or n == 0:
        return dw
    if m == 0:
        return dw.zero_()
    splits, chunk = dw_plan(m, kdim, n, x.dtype, TAPS)[2:]
    part = torch.empty((splits, 3, 3, kdim, n), dtype=torch.float32,
                       device=device)
    rc = kernels.library().port_k5_dw(
        x.data_ptr(), dy.data_ptr(), _ptr(a), _ptr(b), part.data_ptr(),
        dw.data_ptr(), bsz, h, wd, kdim, n, _transform_code(a, relu),
        splits, chunk, code, *kernels.launch_args(device))
    kernels.check(rc, "k5_dw")
    dw_launches += 1
    return dw


# -- the differentiable op ----------------------------------------------------


def _check_args(x, w, a, b) -> None:
    _check_pair(a, b)
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"3x3 kernel expected, got {tuple(w.shape)}")
    if x.dim() != 4 or x.shape[3] != w.shape[2] or x.dtype != w.dtype:
        raise ValueError(f"x [B, H, W, K] and w [3, 3, K, N] of one dtype "
                         f"expected, got x {x.dtype} {tuple(x.shape)}, w "
                         f"{w.dtype} {tuple(w.shape)}")


def conv3_norm_stats(x: torch.Tensor, w: torch.Tensor,
                     a: Optional[torch.Tensor] = None,
                     b: Optional[torch.Tensor] = None, *,
                     relu: bool = True, want_stats: bool = False):
    """Stride-1 SAME 3x3 conv of ``relu(x*a + b)`` for ``x [B, H, W, K]``
    and ``w [3, 3, K, N]`` of one float dtype, with f32 ``a`` and ``b
    [K]`` (both None: no transform, and no relu). Returns ``y [B, H, W,
    N]`` in x's dtype, or ``(y, sum, sumsq)`` with ``want_stats``: f32
    per-channel reductions of the rounded ``y``. Differentiable in ``x``,
    ``w``, ``a`` and ``b``."""
    _check_args(x, w, a, b)
    return FusedNormOp.apply(x, w, a, b, relu and a is not None, want_stats,
                             (conv3_fwd, conv3_dx, conv3_dw))


def conv3_norm_stats_plain(x: torch.Tensor, w: torch.Tensor,
                           a: Optional[torch.Tensor] = None,
                           b: Optional[torch.Tensor] = None, *,
                           relu: bool = True, want_stats: bool = False):
    """:func:`conv3_norm_stats` through the plain versions on any device
    (the model's ``use_kernels=False``): K5f's plain version forward,
    K5dx's and K5dw's as the backward, so it rounds at the kernels'
    points and differs from them only by the order of f32 sums."""
    _check_args(x, w, a, b)
    return FusedNormOp.apply(x, w, a, b, relu and a is not None, want_stats,
                             (conv3_fwd_plain, conv3_dx_plain,
                              conv3_dw_plain))
