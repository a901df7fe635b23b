"""K6, the int8-weight matmul: ``y = x @ W`` with ``W[k, n] = dtype(f32(
q[k, n]) * scale[n])`` — a serving ``Dense`` whose weights stay int8 on
the card (``ops/quant.py``), at the JAX package's in-loop sites.

No TPU kernel stands behind it: it is the counterpart of what XLA fuses
at ``pyspark_tf_gke_tpu/ops/quant.py:136`` ``inloop_dequantize`` (the
convert and the scale folded into the matmul's weight operand, so every
decode step streams int8). ``x`` is ``[..., K]`` in bf16 or f32, ``q``
the flax kernel's ``[K, N]`` int8, ``scale`` one f32 a column. Each
weight is rounded to x's dtype before its product, the products are
summed in f32 and ``y`` is rounded once: the rounding points of
``QTensor.dequantize`` followed by ``nn.Dense(dtype=...)``. The bias is
the caller's (``models/layers.Dense`` adds it after the product).

:func:`int8_matmul_plain` is that arithmetic in plain PyTorch (a
dequantized transient and ``torch.matmul``); :func:`int8_matmul` takes
it only for tensors on the CPU, and a CUDA tensor launches the kernel
(``csrc/int8_matmul.cu``) or raises. :func:`int8_plan` chooses the
launch from the shape alone (the kernel checks it): rows of x a CTA,
split-K ranges until the grid has about one CTA an SM, and 16-byte
weight loads where N is a multiple of 16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

# kept in step with csrc/int8_matmul.cu
TILE_N = 128         # columns a CTA
K_STEP = 32          # K rows a CTA step (8 warps x 4)
MAX_ROWS = 8         # rows of x a CTA
SMEM_FLOATS = 12288  # 48 KB: a CTA's rows of x over its K range
TARGET_CTAS = 132    # split K until the grid has about one CTA an SM
VEC = 16             # int8 weights a 16-byte load
MAX_GRID_YZ = 65535

launches = 0  # K6 launches since the last reset (chip_smoke reads it)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Int8Plan(NamedTuple):
    """K6's launch for one ``[M, K] x [K, N]`` shape."""
    vec: int          # int8 weights a load: 16 (N % 16 == 0) or 1
    rows: int         # rows of x a CTA: 1, 2, 4 or 8
    splits: int       # K ranges (1: y written directly, no second pass)
    k_per_split: int  # K rows a range, a multiple of K_STEP


def int8_plan(m: int, k: int, n: int, dtype: torch.dtype) -> Int8Plan:
    """K6's plan for ``x [m, k]`` of ``dtype`` times ``q [k, n]``:
    the fewest rows of x a CTA (a power of two up to 8) that hold
    ``m``; K cut into ranges of a multiple of 32 rows until the grid
    (column tiles x ranges x row tiles) has about 132 CTAs, within the
    48 KB of shared memory that the CTA's rows of x take; 16-byte loads
    when ``n`` is a multiple of 16, byte loads (masked) otherwise."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul takes a bf16 or f32 x, got {dtype}")
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"int8_matmul needs a nonempty shape, got "
                         f"[{m}, {k}] x [{k}, {n}]")
    rows = 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else MAX_ROWS
    base = _cdiv(n, TILE_N) * _cdiv(m, rows)
    splits = max(1, min(_cdiv(k, K_STEP), _cdiv(TARGET_CTAS, base)))
    kps = min(_cdiv(_cdiv(k, splits), K_STEP) * K_STEP,
              SMEM_FLOATS // rows // K_STEP * K_STEP)
    splits = _cdiv(k, kps)
    if splits > MAX_GRID_YZ or _cdiv(m, rows) > MAX_GRID_YZ:
        raise ValueError(f"int8_matmul grid too large for [{m}, {k}] x "
                         f"[{k}, {n}]")
    return Int8Plan(VEC if n % VEC == 0 else 1, rows, splits, kps)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``x @ dtype(q * scale)`` in plain PyTorch: the weight dequantized
    into a transient of x's dtype, then one ``torch.matmul``."""
    return torch.matmul(x, (q.float() * scale).to(x.dtype))


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K6: ``x [..., K]`` (bf16 or f32) times the int8 weight ``q [K,
    N]`` with f32 column scales ``scale [N]``; ``[..., N]`` in x's
    dtype."""
    global launches
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    device = kernels.require_cuda("int8_matmul", x, q, scale)
    k, n = q.shape
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError(f"int8_matmul takes a contiguous int8 q, got "
                         f"{q.dtype}")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (n,)
            or not scale.is_contiguous()):
        raise ValueError(f"int8_matmul takes a float32 scale [{n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.shape[-1] != k:
        raise ValueError(f"x [..., {x.shape[-1]}] does not meet q [{k}, "
                         f"{n}]")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=device)
    if m == 0:
        return y.reshape(*lead, n)
    plan = int8_plan(m, k, n, x.dtype)
    part = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                        device=device) if plan.splits > 1 else None)
    rc = kernels.library().port_int8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None, m, k, n, plan.vec,
        plan.rows, plan.splits, plan.k_per_split,
        kernels.dtype_code(x.dtype, "int8_matmul"),
        *kernels.launch_args(device))
    kernels.check(rc, "int8_matmul")
    launches += 1
    return y.reshape(*lead, n)
