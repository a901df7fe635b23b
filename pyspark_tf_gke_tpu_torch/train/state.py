"""Training state (counterpart of ``pyspark_tf_gke_tpu/train/state.py``).

The JAX ``TrainState`` is an immutable pytree threaded through a jitted
step. Here the parameters are the model's own tensors (by parameter
name), and :meth:`TrainState.apply_gradients` updates them, the
optimizer state and the optional EMA IN PLACE (no second copy of the
weights), then advances ``step`` — a host integer, so reading it never
waits for the device. The EMA update and the ``ema_decay`` check are
the JAX ones (``:35-37``, ``:47-50``). ``batch_stats`` holds a model's
running BatchNorm statistics by buffer name (the JAX
``TrainState.create(params, tx, batch_stats)``): the same tensors as
the model's buffers, which its forward updates in place in train mode,
so they are state that is saved and restored, not parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any
    tx: Any  # train.harness.Optimizer
    ema_params: Optional[Params] = None
    ema_decay: float = 0.0
    batch_stats: Optional[Params] = None

    @torch.no_grad()
    def apply_gradients(self, grads: Params) -> "TrainState":
        self.tx.update(grads, self.opt_state, self.params)
        if self.ema_params is not None:
            d = self.ema_decay
            ema = list(self.ema_params.values())
            new = [self.params[k] for k in self.ema_params]
            # d * e + (1 - d) * p
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, new, alpha=1.0 - d)
        self.step += 1
        return self

    @classmethod
    def create(cls, params: Params, tx, batch_stats: Optional[Params] = None,
               ema_decay: float = 0.0) -> "TrainState":
        if not 0.0 <= ema_decay < 1.0:
            # decay == 1 would freeze the EMA at init forever (and the
            # export path prefers EMA weights) — reject it loudly.
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if ema_decay else None)
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx,
                   ema_params=ema, ema_decay=ema_decay,
                   batch_stats=batch_stats)
