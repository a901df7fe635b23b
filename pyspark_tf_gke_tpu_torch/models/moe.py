"""Mixture-of-Experts FFN (counterpart of
``pyspark_tf_gke_tpu/models/moe.py``): GShard/Switch top-k routing with
a dense one-hot dispatch, as the JAX layer computes it.

* Routing runs in f32: ``gates = softmax(f32(x) @ router)``, then
  :func:`route` (k rounds of argmax, first index on ties; each token's
  queue position at its expert; tokens past the capacity ``C`` dropped,
  so they fall through the residual).
* The combine weights are normalised over the k picks when ``k > 1``;
  at ``k == 1`` the raw gate is kept, which keeps the router on the
  differentiable main path (Switch).
* The load-balance aux loss is ``E * sum_e mean(top1_mask)_e *
  mean(gates)_e``.
* Dispatch, the expert FFN (gelu, tanh approximation) and combine are
  einsums in ``dtype`` over ``[B, S, E, C]`` one-hot tensors, with
  ``dispatch``, ``combine`` and the biases rounded to ``dtype`` where
  the JAX layer rounds them. The JAX package runs all of this in XLA,
  outside any Pallas kernel, so the port runs ``torch.einsum``.

Parameters keep flax's names and shapes, in f32 whatever the compute
dtype (trainable when ``trainable``): ``router [H, E]``, ``w_in [E, H,
I]``, ``b_in [E, I]``, ``w_out [E, I, H]``, ``b_out [E, H]``.
Expert parallelism (the ``ep`` axis) is P11c's; on a mesh the trainer
sets ``spmd``: the experts' hidden units split on ``tp`` and the aux
loss's means are taken over the whole batch.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pyspark_tf_gke_tpu_torch.models.layers import build_device


def capacity(capacity_factor: float, top_k: int, seq_len: int,
             num_experts: int) -> int:
    """Slots per expert per batch row; at least 1 so tiny shapes route."""
    return max(1, int(capacity_factor * top_k * seq_len / num_experts))


def route(gates: torch.Tensor, k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``gates [B, S, E]`` (f32 softmax) -> ``(dispatch [B, S, E, C],
    combine [B, S, E, C], aux_loss, top1_mask [B, S, E])``, all f32:
    the JAX layer's routing body (``moe.py:91-122``)."""
    b, s, e = gates.shape
    dispatch = gates.new_zeros(b, s, e, cap)
    combine = gates.new_zeros(b, s, e, cap)
    remaining = gates
    # slots each expert has used per batch row as the rounds claim them
    used = gates.new_zeros(b, e)
    top1_mask = None
    for _ in range(k):
        mask = F.one_hot(torch.argmax(remaining, dim=-1), e).to(gates.dtype)
        # queue position of each token at its chosen expert this round
        pos = torch.cumsum(mask, dim=1) * mask - mask + used[:, None, :]
        keep = mask * (pos < cap)
        pos_c = F.one_hot((pos * keep).sum(-1).long(), cap).to(gates.dtype)
        slot = keep[..., None] * pos_c[:, :, None, :]
        gate_k = (remaining * keep).sum(-1, keepdim=True)
        dispatch = dispatch + slot
        combine = combine + slot * gate_k[..., None]
        used = used + keep.sum(1)
        if top1_mask is None:
            top1_mask = mask
        remaining = remaining * (1.0 - mask)
    if k > 1:
        denom = combine.sum(dim=(2, 3), keepdim=True)
        combine = combine / torch.clamp_min(denom, 1e-9)
    frac = top1_mask.mean(dim=(0, 1))
    prob = gates.mean(dim=(0, 1))
    aux = e * (frac * prob).sum()
    return dispatch, combine, aux, top1_mask


class MoELayer(nn.Module):
    """``x [B, S, H] -> (out [B, S, H], aux_loss f32)``."""

    logical_axes = {"router": ("embed", "expert"),
                    "w_in": ("expert", "embed", "mlp"),
                    "b_in": ("expert", "mlp"),
                    "w_out": ("expert", "mlp", "embed"),
                    "b_out": ("expert", "embed")}
    spmd = None  # set by the trainer on a mesh (parallel/spmd.py)

    def __init__(self, num_experts: int, hidden_size: int,
                 intermediate_size: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16,
                 trainable: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        e, h, i = num_experts, hidden_size, intermediate_size
        with torch.device(build_device(device)):
            def param(*shape):
                return nn.Parameter(torch.zeros(*shape, dtype=torch.float32),
                                    requires_grad=trainable)

            self.router = param(h, e)
            self.w_in = param(e, h, i)
            self.b_in = param(e, i)
            self.w_out = param(e, i, h)
            self.b_out = param(e, h)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, s, _ = x.shape
        cap = capacity(self.capacity_factor, self.top_k, s, self.num_experts)
        gates = torch.softmax(x.float() @ self.router, dim=-1)
        dispatch, combine, aux, top1 = route(gates, self.top_k, cap)
        spmd = self.spmd
        tp = spmd.tp if spmd is not None else None
        if spmd is not None:
            # the load-balance terms are means over the whole batch, as
            # the JAX layer takes them over the global array; capacity
            # is per row, so the routing itself needs nothing global
            frac = spmd.mean(top1.mean(dim=(0, 1)))
            prob = spmd.mean(gates.mean(dim=(0, 1)))
            aux = self.num_experts * (frac * prob).sum()
        dt = self.dtype
        xin = tp.copy_to(x) if tp is not None else x
        xe = torch.einsum("bsec,bsh->ebch", dispatch.to(dt), xin.to(dt))
        hmid = torch.einsum("ebch,ehi->ebci", xe, self.w_in.to(dt))
        hmid = F.gelu(hmid + self.b_in[:, None, None, :].to(dt),
                      approximate="tanh")
        ye = torch.einsum("ebci,eih->ebch", hmid, self.w_out.to(dt))
        if tp is not None:  # the expert FFN's hidden units split on tp
            ye = tp.reduce_from(ye)
        ye = ye + self.b_out[:, None, None, :].to(dt)
        out = torch.einsum("bsec,ebch->bsh", combine.to(dt), ye)
        return out.to(x.dtype), aux
