"""Shared run scaffolding for the port's training entry point
(counterpart of ``pyspark_tf_gke_tpu/train/harness.py``): the
optimizer factory, host-local batch sizing, checkpoint setup and
finalisation, run notes and the heartbeat.

:func:`make_optimizer` reproduces the optax transformations the JAX
package builds (``:25-106``), with optax's formulas where they differ
from PyTorch's optimizers:

* adam / adamw: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
  bias corrections ``1 - b**t`` in f32 with ``t`` the update count from
  1, update ``mu_hat / (sqrt(nu_hat) + eps)``; adamw adds ``wd * p`` to
  the update of every parameter with ndim >= 2 (the decay mask) BEFORE
  the learning rate scales it;
* sgd, and ``momentum``: nesterov trace ``t = g + m t``, update ``g + m
  t``;
* the schedule is read at the count BEFORE the update, so the first
  update uses ``lr(0)`` — 0 under ``warmup_cosine``;
* global-norm clipping leaves the gradients alone when their norm is
  below the limit and otherwise divides by the norm and multiplies by
  the limit — no epsilon, unlike ``clip_grad_norm_``.

The updates run as multi-tensor (``torch._foreach_*``) operations, in
place, with no host synchronisation. ``lamb`` and ``adafactor`` are
not ported (ROADMAP, P8).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.train.checkpoint import (CheckpointManager,
                                                       save_history)
from pyspark_tf_gke_tpu_torch.train.resilience import Heartbeat
from pyspark_tf_gke_tpu_torch.utils.fs import fs_write_text, is_remote

# the JAX package's optimizer list (its CLIs offer every name); the last
# two raise here
OPTIMIZERS = ("adam", "adamw", "sgd", "momentum", "lamb", "adafactor")
PORTED_OPTIMIZERS = ("adam", "adamw", "sgd", "momentum")

_F32 = np.float32


def _cosine(init_value: float, decay_steps: int,
            alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` in f32."""
    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + _F32(np.cos(_F32(np.pi) * c
                                                 / _F32(decay_steps))))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cos
                                         + _F32(alpha)))
    return schedule


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int,
                   decay_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (end value 0) in f32."""
    decay = _cosine(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return decay(count - warmup_steps)
        frac = _F32(1) - _F32(min(max(count, 0), warmup_steps)) / _F32(
            warmup_steps)
        return float((_F32(init_value) - _F32(peak_value)) * frac
                     + _F32(peak_value))
    return schedule


class Optimizer:
    """An optax-like gradient transformation over named tensors:
    ``init(params) -> state`` and ``update(grads, state, params)``,
    which applies the update to ``params`` and ``state`` in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, kind: str, lr: Callable[[int], float],
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 grad_clip_norm: float = 0.0):
        self.kind = kind
        self.lr = lr
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {k: torch.zeros_like(p)  # noqa: E731
                         for k, p in params.items()}
        if self.kind in ("adam", "adamw"):
            return {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.kind == "momentum":
            return {"count": 0, "trace": zeros()}
        return {"count": 0}

    def _clip(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        keep = norm < self.grad_clip_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        denom = torch.where(keep, one, norm)
        mult = torch.where(keep, one, one * self.grad_clip_norm)
        return torch._foreach_mul(torch._foreach_div(g, denom), mult)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> None:
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.grad_clip_norm > 0:
            g = self._clip(g)
        lr = self.lr(state["count"])  # optax reads the schedule first
        count = state["count"] + 1
        if self.kind in ("adam", "adamw"):
            mu = [state["mu"][k] for k in names]
            nu = [state["nu"][k] for k in names]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            bc1 = float(_F32(1) - _F32(self.b1) ** _F32(count))
            bc2 = float(_F32(1) - _F32(self.b2) ** _F32(count))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.kind == "adamw" and self.weight_decay:
                idx = [i for i, t in enumerate(p) if t.dim() >= 2]
                decayed = [upd[i] for i in idx]
                torch._foreach_add_(decayed, [p[i] for i in idx],
                                    alpha=self.weight_decay)
        elif self.kind == "momentum":
            trace = [state["trace"][k] for k in names]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            upd = torch._foreach_add(g, trace, alpha=self.momentum)
        else:
            upd = g
        torch._foreach_add_(p, upd, alpha=-lr)
        state["count"] = count


def make_optimizer(learning_rate: float, schedule: str = "constant",
                   total_steps: int = 0, warmup_steps: int = 0,
                   optimizer: str = "adam", weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   grad_clip_norm: float = 0.0) -> Optimizer:
    """adam | adamw | sgd | momentum with a constant | cosine |
    warmup_cosine schedule and optional global-norm clipping; the same
    argument checks as the JAX factory."""
    if schedule not in ("constant", "cosine", "warmup_cosine"):
        raise ValueError(
            f"unknown lr schedule {schedule!r}; use constant | cosine | "
            "warmup_cosine")
    if optimizer in ("lamb", "adafactor"):
        raise NotImplementedError(
            f"--optimizer {optimizer} is not ported (ROADMAP, P8); use "
            + " | ".join(PORTED_OPTIMIZERS))
    if optimizer not in PORTED_OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; use "
                         + " | ".join(OPTIMIZERS))
    if weight_decay and optimizer != "adamw":
        raise ValueError(
            f"weight_decay={weight_decay} is ignored by optimizer "
            f"{optimizer!r} — use adamw (or set weight_decay=0)")
    if warmup_steps and schedule != "warmup_cosine":
        raise ValueError(
            f"warmup_steps={warmup_steps} is ignored by schedule "
            f"{schedule!r} — use warmup_cosine (or set warmup_steps=0)")
    if schedule != "constant" and total_steps <= 0:
        raise ValueError(
            f"lr schedule {schedule!r} needs total_steps > 0 (a decay over 0 "
            "steps would pin the learning rate at ~0 for the whole run)")
    if schedule == "constant":
        lr = lambda count: float(_F32(learning_rate))  # noqa: E731
    elif schedule == "cosine":
        lr = _cosine(learning_rate, total_steps)
    else:
        lr = _warmup_cosine(0.0, learning_rate, max(warmup_steps, 1),
                            max(total_steps, warmup_steps + 1))
    return Optimizer(optimizer, lr, weight_decay=weight_decay,
                     momentum=momentum, grad_clip_norm=grad_clip_norm)


def local_batch_size(global_batch: int) -> int:
    """Per-process batch from the GLOBAL batch size: all of it, in the
    one process the port runs (multi-process training: ROADMAP, P8)."""
    return global_batch


def make_checkpoint(output_dir: str, every_steps: int, state, resume: bool,
                    async_save: bool = False):
    """``(CheckpointManager under output_dir/checkpoints, state)``,
    restoring the latest step into ``state`` when resuming."""
    ckpt = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                             every_steps=every_steps, async_save=async_save)
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
    return ckpt, state


def finalize_run(ckpt: CheckpointManager, state, history: Dict,
                 output_dir: str, model_name: str = "model") -> None:
    """Terminal save: checkpoint + history.json + run notes."""
    ckpt.save(state, history)
    ckpt.wait()
    save_history(output_dir, history)
    save_run_notes(output_dir, model_name, state, history)


def save_run_notes(output_dir: str, model_name: str, state,
                   history: Dict) -> str:
    """``<model_name>.txt``: parameter count and size, device, final
    step and final metrics."""
    path = os.path.join(output_dir, f"{model_name}.txt")
    leaves = list(state.params.values())
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    device = leaves[0].device
    kind = (f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else "")
    lines = [
        f"model: {model_name}",
        f"total params: {n_params:,}",
        f"size: {n_bytes / (1 << 20):.2f} MB",
        f"devices: 1x {device.type}{kind}",
        "processes: 1",
        f"final step: {state.step}",
        f"epochs recorded: {len(history.get('loss', []))}",
    ]
    for key, vals in sorted(history.items()):
        if vals:
            lines.append(f"final {key}: {vals[-1]:.6g}")
    fs_write_text(path, "\n".join(lines) + "\n")
    return path


def make_heartbeat(output_dir: str, every_steps: int,
                   path: str = "") -> Optional[Heartbeat]:
    if not every_steps:
        return None
    if not path:
        if is_remote(output_dir):
            raise NotImplementedError(
                f"{output_dir!r}: object-store output directories are not "
                "ported (ROADMAP, P8)")
        path = os.path.join(output_dir, "heartbeat-{process_index}.json")
    return Heartbeat(path, every_steps)
