"""Shared run scaffolding for the port's training entry point
(counterpart of ``pyspark_tf_gke_tpu/train/harness.py``): the
optimizer factory, host-local batch sizing, checkpoint setup and
finalisation, run notes and the heartbeat.

:func:`make_optimizer` reproduces the optax transformations the JAX
package builds (``:25-106``), with optax's formulas where they differ
from PyTorch's optimizers:

* adam / adamw: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
  bias corrections ``1 - b**t`` in f32 with ``t`` the update count from
  1, update ``mu_hat / (sqrt(nu_hat) + eps)``, ``eps`` optax's 1e-8
  unless given (``optax.adam(eps=)``; Keras' 1e-7 for the
  reference-parity runs); adamw adds ``wd * p`` to
  the update of every parameter with ndim >= 2 (the decay mask) BEFORE
  the learning rate scales it. ``mu_dtype`` (``optax.adam(mu_dtype=)``)
  stores the first moment in that dtype: a step computes it in f32 from
  the stored moment (``b1 * mu`` in the stored dtype, ``b1`` itself
  rounded to it, as jnp casts a Python float) and the f32 gradient, uses
  it in f32, and only the stored copy is rounded;
* sgd, and ``momentum``: nesterov trace ``t = g + m t``, update ``g + m
  t``;
* the schedule is read at the count BEFORE the update, so the first
  update uses ``lr(0)`` — 0 under ``warmup_cosine``;
* lamb (``optax.lamb``): adam's update with ``eps = 1e-6``, plus ``wd *
  p`` under the decay mask, scaled per leaf by the trust ratio
  ``||p|| / ||u||`` (1 where either norm is 0), then by ``-lr``;
* adafactor (``optax.adafactor`` at its defaults): per leaf, the second
  moment decays at ``1 - (t+1)^-0.8`` and is factored over the leaf's
  two largest dims (``np.argsort`` of its shape, the same tie order)
  when the smaller of them is at least 128, else kept whole; ``g^2 +
  1e-30`` feeds it; the update ``g / sqrt(v)`` is clipped to block RMS
  1, scaled by ``lr`` and by ``max(rms(p), 1e-3)``, then ``wd * p`` is
  added under the mask when ``weight_decay`` is set, and the sum is
  subtracted. No momentum;
* global-norm clipping leaves the gradients alone when their norm is
  below the limit and otherwise divides by the norm and multiplies by
  the limit — no epsilon, unlike ``clip_grad_norm_``.

Both lamb and adafactor depend on each leaf's shape: every parameter is
updated at its flax shape under its flax path (``models/layers.py``),
never fused or reshaped. The updates run as multi-tensor
(``torch._foreach_*``) operations where the rule is elementwise and per
leaf otherwise, in place, with no host synchronisation.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.train.checkpoint import (CheckpointManager,
                                                       save_history)
from pyspark_tf_gke_tpu_torch.train.resilience import Heartbeat
from pyspark_tf_gke_tpu_torch.utils.fs import fs_write_text, is_remote

# the JAX package's optimizer list (its CLIs offer every name)
OPTIMIZERS = ("adam", "adamw", "sgd", "momentum", "lamb", "adafactor")
# the optimizers that take a weight decay
DECAYING = ("adamw", "lamb", "adafactor")

# optax.adafactor's defaults
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_SCALE = 1e-3

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


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: ``(second largest, largest)`` axis of
    a leaf whose two largest dims are both >= 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


class Optimizer:
    """An optax-like gradient transformation over named tensors:
    ``init(params) -> state`` and ``update(grads, state, params)``,
    which applies the update to ``params`` and ``state`` in place."""

    b1, b2 = 0.9, 0.999

    def __init__(self, kind: str, lr: Callable[[int], float],
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 grad_clip_norm: float = 0.0, eps: Optional[float] = None,
                 mu_dtype: Optional[torch.dtype] = None):
        self.kind = kind
        self.mu_dtype = mu_dtype
        self.lr = lr
        # optax's defaults: adam and adamw 1e-8, lamb 1e-6
        self.eps = eps if eps is not None else (
            1e-6 if kind == "lamb" else 1e-8)
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda dtype=None: {  # noqa: E731
            k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
        if self.kind in ("adam", "adamw", "lamb"):
            return {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros()}
        if self.kind == "momentum":
            return {"count": 0, "trace": zeros()}
        if self.kind == "adafactor":
            state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
            for k, p in params.items():
                dims = _factored_dims(tuple(p.shape))
                if dims is None:
                    state["v"][k] = torch.zeros_like(p)
                    continue
                d1, d0 = dims
                state["v_row"][k] = torch.zeros_like(p.select(d0, 0))
                state["v_col"][k] = torch.zeros_like(p.select(d1, 0))
            return state
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
        if self.kind in ("adam", "adamw", "lamb"):
            upd = self._adam(names, g, state, count)
            if self.kind != "adam" and self.weight_decay:
                self._decay(upd, p, self.weight_decay)
            if self.kind == "lamb":
                self._trust_ratio(upd, p)
        elif self.kind == "adafactor":
            upd = self._adafactor(names, g, p, state, lr)
            if self.weight_decay:
                self._decay(upd, p, self.weight_decay)
            lr = 1.0  # scaled inside, before the parameter scale
        elif self.kind == "momentum":
            trace = [state["trace"][k] for k in names]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            upd = torch._foreach_add(g, trace, alpha=self.momentum)
        else:
            upd = g
        torch._foreach_add_(p, upd, alpha=-lr)
        state["count"] = count

    def _adam(self, names, g, state, count) -> List[torch.Tensor]:
        """``scale_by_adam``: the moments updated in place; returns
        ``mu_hat / (sqrt(nu_hat) + eps)``."""
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        if self.mu_dtype is None:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        else:
            stored = mu
            # jnp casts the Python float to the moment's dtype first
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype).item()
            mu = [t.float() for t in torch._foreach_mul(stored, b1)]
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_copy_(stored, mu)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        bc1 = float(_F32(1) - _F32(self.b1) ** _F32(count))
        bc2 = float(_F32(1) - _F32(self.b2) ** _F32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(torch._foreach_div(mu, bc1), denom)

    @staticmethod
    def _decay(upd, p, weight_decay: float) -> None:
        """``add_decayed_weights`` under the mask ``ndim >= 2``."""
        idx = [i for i, t in enumerate(p) if t.dim() >= 2]
        torch._foreach_add_([upd[i] for i in idx], [p[i] for i in idx],
                            alpha=weight_decay)

    @staticmethod
    def _trust_ratio(upd, p) -> None:
        """``scale_by_trust_ratio``: each leaf times ``||p|| / ||u||``,
        or 1 where either norm is 0."""
        p_norm = torch.stack(torch._foreach_norm(p))
        u_norm = torch.stack(torch._foreach_norm(upd))
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        torch._foreach_mul_(upd, list(ratio.unbind()))

    def _adafactor(self, names, g, p, state, lr: float
                   ) -> List[torch.Tensor]:
        """``scale_by_factored_rms``, ``clip_by_block_rms``, the learning
        rate and ``scale_by_param_block_rms``, leaf by leaf."""
        t = _F32(state["count"] + 1)
        decay = float(_F32(1) - t ** _F32(-ADAFACTOR_DECAY_RATE))
        out = []
        for k, gi, pi in zip(names, g, p):
            g2 = gi * gi + ADAFACTOR_EPS
            dims = _factored_dims(tuple(pi.shape))
            if dims is None:
                v = state["v"][k]
                v.mul_(decay).add_(g2, alpha=1.0 - decay)
                u = gi * torch.rsqrt(v)
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][k], state["v_col"][k]
                v_row.mul_(decay).add_(g2.mean(dim=d0), alpha=1.0 - decay)
                v_col.mul_(decay).add_(g2.mean(dim=d1), alpha=1.0 - decay)
                rd1 = d1 - 1 if d1 > d0 else d1
                row = torch.rsqrt(v_row / v_row.mean(dim=rd1, keepdim=True))
                u = (gi * row.unsqueeze(d0)) * torch.rsqrt(v_col).unsqueeze(
                    d1)
            u = u / torch.clamp_min(_rms(u) / ADAFACTOR_CLIP, 1.0)
            out.append(u * lr * torch.clamp_min(_rms(pi),
                                                 ADAFACTOR_MIN_SCALE))
        return out


def make_optimizer(learning_rate: float, schedule: str = "constant",
                   total_steps: int = 0, warmup_steps: int = 0,
                   optimizer: str = "adam", weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   grad_clip_norm: float = 0.0,
                   eps: Optional[float] = None,
                   mu_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """adam | adamw | sgd | momentum | lamb | adafactor with a constant |
    cosine | warmup_cosine schedule and optional global-norm clipping; the same
    argument checks as the JAX factory. ``eps`` is the Adam-family
    epsilon (default optax's: 1e-8, lamb 1e-6); ``mu_dtype`` the dtype
    the Adam family stores its first moment in (default the
    parameter's)."""
    if schedule not in ("constant", "cosine", "warmup_cosine"):
        raise ValueError(
            f"unknown lr schedule {schedule!r}; use constant | cosine | "
            "warmup_cosine")
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; use "
                         + " | ".join(OPTIMIZERS))
    if weight_decay and optimizer not in DECAYING:
        raise ValueError(
            f"weight_decay={weight_decay} is ignored by optimizer "
            f"{optimizer!r} — use adamw, lamb or adafactor (or set "
            "weight_decay=0)")
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
                     momentum=momentum, grad_clip_norm=grad_clip_norm,
                     eps=eps, mu_dtype=mu_dtype)


def local_batch_size(global_batch: int) -> int:
    """Per-process batch from the GLOBAL batch size: all of it, in the
    one process the port runs (multi-process training: ROADMAP, P11)."""
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
        # a heartbeat is node-local (a probe reads its mtime): with an
        # object-store output directory it goes to /tmp, per process
        path = ("/tmp/tpu-heartbeat-{process_index}.json"
                if is_remote(output_dir)
                else os.path.join(output_dir,
                                  "heartbeat-{process_index}.json"))
    return Heartbeat(path, every_steps)
