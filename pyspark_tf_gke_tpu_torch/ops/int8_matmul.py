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
dequantized transient and ``torch.matmul``); :func:`int8_matmul` and
:func:`int8_matmul_group` (up to three weights that share ``x``, one
launch) take it only for tensors on the CPU, and a CUDA tensor launches
the kernel (``csrc/int8_matmul.cu``) or raises. :func:`int8_plan`
chooses the launch from the shape alone (the kernel checks it): rows of
x a CTA, K split into a thread-block cluster of at most 8 CTAs until the
grid has about one CTA an SM, x's window in shared memory, and 16-byte
weight copies where every N is a multiple of 16.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

# kept in step with csrc/int8_matmul.cu hop::
TILE_N = 64          # columns a CTA
STAGE_K = 64         # K rows a ring slot
STAGES = 8           # ring slots
K_ALIGN = 16         # a split's K rows are a multiple of this
MAX_CLUSTER = 8      # splits of a column tile: one cluster
TARGET_CTAS = 132    # split K until the grid has about one CTA an SM
X_BYTES = 48 * 1024  # x's window in shared memory
X_PAD = 16           # elements past each row of x's window
PARTS = 4            # the warps whose sums meet in shared memory
MAX_GROUPS = 3       # weights a launch
VEC = 16             # int8 weights a 16-byte copy
MAX_GRID_YZ = 65535

launches = 0  # K6 launches since the last reset (chip_smoke reads it)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Int8Plan(NamedTuple):
    """K6's launch for one ``[M, K] x [K, N...]`` call."""
    vec: int          # int8 weights a copy: 16 (every N % 16 == 0) or 1
    rows: int         # rows of x a CTA: 8, 16 or 32
    splits: int       # K ranges: the CTAs of a cluster
    k_per_split: int  # K rows a range
    x_window: int     # K rows of x in shared memory at a time
    smem: int         # dynamic shared memory of a CTA, bytes


def int8_plan(m: int, k: int, ns: Union[int, Sequence[int]],
              dtype: torch.dtype) -> Int8Plan:
    """K6's plan for ``x [m, k]`` of ``dtype`` times the int8 weights
    ``[k, n]`` for each ``n`` of ``ns`` (one launch): 8, 16 or 32 rows
    of x a CTA (the fewest that hold ``m``, up to 32); K cut into at
    most 8 ranges of a multiple of 16 rows, each range at least 64 rows,
    until the grid (64-column tiles of every weight x row blocks x
    ranges) has about 132 CTAs; x's window the CTA's whole range where
    48 KB hold it; 16-byte copies when every ``n`` is a multiple of 16,
    byte loads (masked) otherwise."""
    ns = (ns,) if isinstance(ns, int) else tuple(ns)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_matmul takes a bf16 or f32 x, got {dtype}")
    if not 1 <= len(ns) <= MAX_GROUPS:
        raise ValueError(f"int8_matmul takes 1-{MAX_GROUPS} weights a "
                         f"launch, got {len(ns)}")
    if m < 1 or k < 1 or min(ns) < 1:
        raise ValueError(f"int8_matmul needs a nonempty shape, got "
                         f"[{m}, {k}] x [{k}, {list(ns)}]")
    rows = 8 if m <= 8 else 16 if m <= 16 else 32
    tiles = sum(_cdiv(n, TILE_N) for n in ns)
    blocks = _cdiv(m, rows)
    if tiles > MAX_GRID_YZ or blocks > MAX_GRID_YZ:
        raise ValueError(f"int8_matmul grid too large for [{m}, {k}] x "
                         f"[{k}, {list(ns)}]")
    want = max(1, min(MAX_CLUSTER, _cdiv(TARGET_CTAS, tiles * blocks),
                      k // STAGE_K))
    kps = _cdiv(_cdiv(k, want), K_ALIGN) * K_ALIGN
    size = dtype.itemsize
    window = min(_cdiv(kps, STAGE_K) * STAGE_K,
                 (X_BYTES // (rows * size) - X_PAD) // STAGE_K * STAGE_K)
    smem = (rows * (window + X_PAD) * size
            + max(STAGES * STAGE_K * TILE_N, (PARTS + 1) * 4 * rows * TILE_N))
    vec = VEC if all(n % VEC == 0 for n in ns) else 1
    return Int8Plan(vec, rows, _cdiv(k, kps), kps, window, smem)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """``x @ dtype(q * scale)`` in plain PyTorch: the weight dequantized
    into a transient of x's dtype, then one ``torch.matmul``."""
    return torch.matmul(x, (q.float() * scale).to(x.dtype))


def _check_weight(q: torch.Tensor, scale: torch.Tensor, k: int) -> int:
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous():
        raise ValueError(f"int8_matmul takes a contiguous int8 q [K, N], "
                         f"got {q.dtype} {tuple(q.shape)}")
    n = q.shape[1]
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (n,)
            or not scale.is_contiguous()):
        raise ValueError(f"int8_matmul takes a float32 scale [{n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if q.shape[0] != k:
        raise ValueError(f"x [..., {k}] does not meet q {tuple(q.shape)}")
    return n


def _launch(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor,
                                                      torch.Tensor]]
            ) -> List[torch.Tensor]:
    global launches
    device = kernels.require_cuda(
        "int8_matmul", x, *[t for w in weights for t in w])
    k = x.shape[-1]
    ns = [_check_weight(q, scale, k) for q, scale in weights]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    ys = [torch.empty((m, n), dtype=x.dtype, device=device) for n in ns]
    if m > 0:
        plan = int8_plan(m, k, ns, x.dtype)
        pad = MAX_GROUPS - len(weights)
        qs = [q.data_ptr() for q, _ in weights] + [None] * pad
        scales = [s.data_ptr() for _, s in weights] + [None] * pad
        outs = [y.data_ptr() for y in ys] + [None] * pad
        rc = kernels.library().port_int8_matmul(
            x2.data_ptr(), *qs, *scales, *outs, *(ns + [0] * pad),
            len(weights), m, k, plan.vec, plan.rows, plan.splits,
            plan.k_per_split, plan.x_window,
            kernels.dtype_code(x.dtype, "int8_matmul"),
            *kernels.launch_args(device))
        kernels.check(rc, "int8_matmul")
        launches += 1
    return [y.reshape(*lead, n) for y, n in zip(ys, ns)]


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """K6: ``x [..., K]`` (bf16 or f32) times the int8 weight ``q [K,
    N]`` with f32 column scales ``scale [N]``; ``[..., N]`` in x's
    dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    return _launch(x, ((q, scale),))[0]


def int8_matmul_group(x: torch.Tensor,
                      weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                      ) -> List[torch.Tensor]:
    """K6 for up to three int8 weights ``(q [K, N_i], scale [N_i])`` that
    share ``x [..., K]``, in one launch: ``[x @ W_i for each]``, each as
    :func:`int8_matmul` gives it."""
    if x.device.type == "cpu":
        return [int8_matmul_plain(x, q, scale) for q, scale in weights]
    return _launch(x, weights)
