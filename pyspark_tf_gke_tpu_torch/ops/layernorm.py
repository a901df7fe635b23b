"""Fused LayerNorm forward (K3): ``y = LN(x)`` or ``y = LN(x + r)``.

Counterpart of ``pyspark_tf_gke_tpu/ops/pallas/layernorm.py``. The
statistics are f32 for any input dtype and ``y`` comes back in ``x``'s
dtype. The kernel is ``csrc/layernorm.cu``; :func:`layernorm_plain` is
the same closed form in plain PyTorch. :func:`fused_layernorm` takes
the plain version only for tensors that lie on the CPU; a CUDA tensor
launches the kernel or raises. Forward only: the closed-form backward
(``layernorm.py:98-137``) waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from pyspark_tf_gke_tpu_torch.ops import kernels

MAX_D = 1024  # csrc/layernorm.cu keeps D/32 values per lane in registers

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def fused_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-6,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis of ``x [..., D]`` with f32 ``scale``
    and ``bias [D]``; ``residual`` (same shape and dtype as ``x``) gives
    ``LN(x + residual)`` with the add inside the kernel."""
    global launches
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps, residual)
    tensors = (x, scale, bias) + ((residual,) if residual is not None else ())
    device = kernels.require_cuda("layernorm", *tensors)
    d = x.shape[-1]
    if not 0 < d <= MAX_D:
        raise ValueError(f"layernorm kernel takes 0 < D <= {MAX_D}, got {d}")
    if scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"scale/bias must be [{d}], got "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("layernorm kernel takes float32 scale and bias")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError("residual must match x in shape and dtype")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("layernorm kernel takes contiguous tensors")
    code = kernels.dtype_code(x.dtype, "layernorm")
    if code == kernels.DTYPE_CODES[torch.int8]:
        raise TypeError("layernorm kernel takes a float x")
    y = torch.empty_like(x)
    rows = x.numel() // d
    lib = kernels.library()
    rc = lib.port_layernorm(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        float(eps), code, *kernels.launch_args(device))
    kernels.check(rc, "layernorm")
    launches += 1
    return y
