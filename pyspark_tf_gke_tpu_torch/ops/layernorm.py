"""Fused LayerNorm (K3 forward, K3b backward): ``y = LN(x)`` or
``y = LN(x + r)``, differentiable.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/layernorm.py``. The
statistics are f32 for any input dtype and ``y`` comes back in ``x``'s
dtype. :func:`fused_layernorm` is a ``torch.autograd.Function``: its
forward is the K3 kernel (``csrc/layernorm.cu``) and its backward the
K3b kernel (``csrc/layernorm_bwd.cu``), the closed-form gradient of
``_ln_bwd`` / ``_ln_res_bwd`` (``layernorm.py:98-137``): dx (returned
for the residual too), f32 dscale and dbias. :func:`layernorm_plain`
and :func:`layernorm_bwd_plain` are the same closed forms in plain
PyTorch; the wrappers take them only for tensors that lie on the CPU,
and a CUDA tensor launches the kernel or raises. The plain versions
compute in f32, or in f64 for f64 inputs (``gradcheck``).

Both kernels take any row width ``0 < D <= MAX_D`` (8192); the JAX
kernel takes any D. :func:`ln_plan` chooses each one's variant and launch
shape from D, the dtype and the pointers' alignment; the wrappers pass
it to the kernels, which check it. K3 keeps its first design (a warp a
row) up to D 1024; K3b has one design for every D: 16-byte loads where
D and the pointers allow, a row on the fewest warps at which a thread
holds at most 3 chunks in bf16, 4 in f32 (8 elements with scalar
loads), the values a thread holds sized by D.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

MAX_D = 8192  # the widest row csrc/layernorm*.cu take
# Up to NARROW_D K3 takes a warp a row, 32 values a lane, 4 rows a
# block. Beyond, K3 (csrc/layernorm.cu) takes at most MAX_VEC_PER
# 16-byte chunks a thread, or SCALAR_PER elements in the scalar variant,
# in CTAs of CTA_THREADS (or a row's threads, if more). K3b
# (csrc/layernorm_bwd.cu) takes that rule at every D: at most
# BWD_MAX_CHUNKS[bytes an element] chunks or BWD_SCALAR_PER elements a
# thread (within 128 registers), CTAs of BWD_CTA_THREADS (or a row's
# threads), on a fixed grid of at most BWD_MAX_BLOCKS CTAs.
NARROW_D = 1024
MAX_VEC_PER = 4
SCALAR_PER = 8
CTA_THREADS = 256
BWD_MAX_CHUNKS = {2: 3, 4: 4}  # bf16: 3 chunks a thread, f32: 4
BWD_SCALAR_PER = 8
BWD_CTA_THREADS = 256
BWD_MAX_BLOCKS = 256  # K3b's fixed grid: one partial-sum row per block

launches = 0  # K3 launches since the last reset (chip_smoke reads it)
bwd_launches = 0  # K3b launches since the last reset


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' arithmetic type: f32, or f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = _acc(x)
    if residual is not None:
        xf = xf + _acc(residual)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * _acc(scale) + _acc(bias)
    return y.to(x.dtype)


def layernorm_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        eps: float = 1e-6,
                        residual: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)`` of :func:`layernorm_plain` for the output
    gradient ``g``. With ``residual`` the statistics come from ``x + r``
    rounded to x's dtype, as ``_ln_res_bwd`` recomputes them, and ``dx``
    is also the residual's gradient."""
    d = x.shape[-1]
    xs = x if residual is None else (_acc(x) + _acc(residual)).to(x.dtype)
    xf = _acc(xs).reshape(-1, d)
    gf = _acc(g).reshape(-1, d).to(xf.dtype)
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    gs = gf * scale.to(xf.dtype)[None, :]
    dx = inv / d * (d * gs - gs.sum(-1, keepdim=True)
                    - xhat * (gs * xhat).sum(-1, keepdim=True))
    dscale = (gf * xhat).sum(0)
    dbias = gf.sum(0)
    return (dx.to(x.dtype).reshape(x.shape), dscale.to(scale.dtype),
            dbias.to(scale.dtype))


class LnPlan(NamedTuple):
    """The launch shape of K3 and K3b for one row width."""
    vec: int  # K3: elements a load: a 16-byte chunk, or 1 (scalar loads)
    per: int  # K3: loads a thread makes of a row
    row_threads: int  # K3: threads a row (> 32: a block reduction)
    threads: int  # K3: threads a CTA
    bwd_vec: int  # K3b: elements a load
    bwd_per: int  # K3b: loads a thread makes of a row
    bwd_row_threads: int  # K3b: threads a row
    bwd_threads: int  # K3b: threads a CTA

    @property
    def bwd_rows_a_part(self) -> int:
        """Rows a K3b CTA has in flight, one partial-sum row a CTA."""
        return self.bwd_threads // self.bwd_row_threads


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_plan(d: int, chunk: int, aligned: bool, most_vec: int,
               scalar_per: int, cta: int) -> Tuple[int, int, int, int]:
    """``(vec, per, row_threads, threads)``: 16-byte chunks of ``chunk``
    elements where ``d`` is a multiple of one and ``aligned``, else one
    element a load; a row on the fewest threads (a power of two, at least
    a warp) that cover it with at most ``most_vec`` chunks or
    ``scalar_per`` elements each; CTAs of ``cta`` threads or a row's."""
    vec = chunk if aligned and d % chunk == 0 else 1
    n = _cdiv(d, vec)
    most = most_vec if vec > 1 else scalar_per
    row_threads = 32
    while row_threads * most < n:
        row_threads *= 2
    per = _cdiv(n, row_threads) if vec > 1 else scalar_per
    return vec, per, row_threads, max(row_threads, cta)


def ln_plan(d: int, dtype: torch.dtype, aligned: bool = True) -> LnPlan:
    """K3's and K3b's variant and launch shape for rows of ``d`` elements
    of ``dtype`` (``aligned``: every tensor the kernel touches starts on
    16 bytes). Up to 1024 K3 keeps its first design, a warp a row (32
    values a lane). Beyond, K3 reads 16-byte chunks where ``d`` is a
    multiple of one and ``aligned``, else one element at a time (the
    scalar variant), and a row belongs to the fewest threads (a power of
    two) that cover it with at most 4 chunks or 8 elements each. K3b
    takes that rule at every ``d``, with at most 3 chunks a thread in
    bf16. Raises for ``d`` outside ``0 < d <= MAX_D``."""
    if not 0 < d <= MAX_D:
        raise ValueError(f"the layernorm kernels take 0 < D <= {MAX_D}, got "
                         f"{d}")
    chunk = 16 // dtype.itemsize
    bwd = _rows_plan(d, chunk, aligned, BWD_MAX_CHUNKS[dtype.itemsize],
                     BWD_SCALAR_PER, BWD_CTA_THREADS)
    if d <= NARROW_D:
        return LnPlan(1, 32, 32, 128, *bwd)
    return LnPlan(*_rows_plan(d, chunk, aligned, MAX_VEC_PER, SCALAR_PER,
                              CTA_THREADS), *bwd)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _check(kernel: str, x, scale, residual, *rest) -> torch.device:
    tensors = ((x, scale) + rest
               + ((residual,) if residual is not None else ()))
    device = kernels.require_cuda(kernel, *tensors)
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"{kernel} kernel takes float32 scale [{d}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("residual must match x in shape and dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} kernel takes contiguous tensors")
    if kernels.dtype_code(x.dtype, kernel) == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError(f"{kernel} kernel takes a float x")
    ln_plan(d, x.dtype)  # raises for a width the kernels do not take
    return device


def layernorm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: ``LN(x)`` or ``LN(x + residual)`` (no autograd)."""
    global launches
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps, residual)
    device = _check("layernorm", x, scale, residual, bias)
    d = x.shape[-1]
    if bias.shape != (d,) or bias.dtype != torch.float32:
        raise ValueError(f"layernorm kernel takes float32 bias [{d}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    y = torch.empty_like(x)
    plan = ln_plan(d, x.dtype, _aligned(x, residual, scale, bias, y))
    lib = kernels.library()
    rc = lib.port_layernorm(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // d, d,
        float(eps), plan.vec, plan.per, plan.row_threads, plan.threads,
        kernels.dtype_code(x.dtype, "layernorm"),
        *kernels.launch_args(device))
    kernels.check(rc, "layernorm")
    launches += 1
    return y


def layernorm_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6, residual: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3b: ``(dx, dscale, dbias)`` for the output gradient ``g``."""
    global bwd_launches
    if x.device.type == "cpu":
        return layernorm_bwd_plain(g, x, scale, eps, residual)
    device = _check("layernorm_bwd", x, scale, residual, g)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("the output gradient must match x in shape and dtype")
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        zero = torch.zeros(d, dtype=torch.float32, device=device)
        return dx, zero, zero.clone()
    plan = ln_plan(d, x.dtype, _aligned(x, residual, g, scale, dx))
    nparts = min(BWD_MAX_BLOCKS, _cdiv(rows, plan.bwd_rows_a_part))
    parts = torch.empty((2, nparts, d), dtype=torch.float32, device=device)
    dscale = torch.empty(d, dtype=torch.float32, device=device)
    dbias = torch.empty(d, dtype=torch.float32, device=device)
    lib = kernels.library()
    rc = lib.port_layernorm_bwd(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        g.data_ptr(), scale.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), dscale.data_ptr(), dbias.data_ptr(), rows, d,
        nparts, plan.bwd_vec, plan.bwd_per, plan.bwd_row_threads,
        plan.bwd_threads, float(eps),
        kernels.dtype_code(x.dtype, "layernorm_bwd"),
        *kernels.launch_args(device))
    kernels.check(rc, "layernorm_bwd")
    bwd_launches += 1
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps):
        ctx.save_for_backward(x, scale, residual)
        ctx.eps = eps
        return layernorm_fwd(x, scale, bias, eps, residual)

    @staticmethod
    def backward(ctx, g):
        x, scale, residual = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd(g.contiguous(), x, scale, ctx.eps,
                                          residual)
        return (dx, dscale, dbias, dx if residual is not None else None,
                None)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis of ``x [..., D]`` with f32 ``scale``
    and ``bias [D]``; ``residual`` (same shape and dtype as ``x``) gives
    ``LN(x + residual)`` with the add inside the kernel. Differentiable
    in ``x``, ``scale``, ``bias`` and ``residual`` (K3b)."""
    return _LayerNorm.apply(x, scale, bias, residual, eps)
