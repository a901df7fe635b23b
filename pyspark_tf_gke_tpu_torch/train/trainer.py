"""The trainer: train step + epoch loop (counterpart of
``pyspark_tf_gke_tpu/train/trainer.py``, the causal-LM and ResNet tasks).

A step is forward, loss, ``backward`` and the optimizer update, eager on
one device: the attention, LayerNorm and fused 1x1-conv gradients come
from the port's kernels (K2dq/K2dkv, K3b, K4dx/K4dw) through their
``autograd.Function``s, the rest from PyTorch's autograd. A task with
BatchNorm statistics (``has_batch_stats``) keeps the model's buffers in
``TrainState.batch_stats``: the train-mode forward updates them in
place, and ``evaluate`` runs the forward with ``train=False``, which
reads them. The epoch loop keeps the JAX one's contract:

* metrics accumulate as device scalars — no host sync inside the step
  loop, so the host queues step ``n+1`` while the device runs step ``n``;
* each epoch's first step is synchronised and timed apart, and the
  ``step_time_ms`` / ``examples_per_sec`` of the history cover the other
  steps;
* batches reach the device through a prefetch of 2 (pinned host memory,
  ``data/pipeline.py``);
* the history has the same keys: ``loss``, ``next_token_accuracy``,
  ``step_time_ms``, ``examples_per_sec`` and ``val_*``.

The JAX trainer's metrics registry and event trail, its sharding and
its other tasks are not ported (ROADMAP, P8 and P9).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from pyspark_tf_gke_tpu_torch.data.pipeline import prefetch_to_device, put_batch
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
from pyspark_tf_gke_tpu_torch.train.losses import (accuracy_metric,
                                                   per_token_cross_entropy,
                                                   softmax_cross_entropy)
from pyspark_tf_gke_tpu_torch.train.state import TrainState
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.trainer")

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainerTask:
    """How a model family plugs into the step: how to call it
    (``forward(model, batch, train=True) -> preds``) and how to score it
    (``loss_and_metrics(preds, batch) -> (loss, metrics)``)."""

    name: str
    forward: Callable[..., Any]
    loss_and_metrics: Callable[[Any, Batch],
                               Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    has_batch_stats: bool = False


def causal_lm_task(vocab_chunks: Optional[int] = None) -> TrainerTask:
    """Next-token prediction: shift-by-one cross entropy over every
    position that has a successor, masked by ``attention_mask`` when the
    batch carries one (the JAX task's dense loss, ``:184-243``)."""
    if vocab_chunks:
        raise NotImplementedError(
            "--vocab-chunks (the chunked large-vocab loss, ops/chunked_ce.py)"
            " is not ported (ROADMAP, P8)")

    def _reduce(per_tok, pred_ids, targets, mask):
        if mask is not None:
            m = mask[:, 1:].float()
            denom = m.sum().clamp_min(1.0)
            loss = (per_tok * m).sum() / denom
            acc = ((pred_ids == targets) * m).sum() / denom
        else:
            loss = per_tok.mean()
            acc = (pred_ids == targets).float().mean()
        return loss, {"loss": loss, "next_token_accuracy": acc}

    def forward(model, batch, train=True):
        return model(batch["input_ids"].long(),
                     segment_ids=batch.get("segment_ids"))

    def lam(logits, batch):
        targets = batch["input_ids"][:, 1:].long()
        lg = logits[:, :-1].float()
        per_tok = per_token_cross_entropy(lg, targets)
        return _reduce(per_tok, torch.argmax(lg, -1), targets,
                       batch.get("attention_mask"))

    return TrainerTask("causal_lm", forward, lam)


def _image_cls_lam(preds, batch):
    loss = softmax_cross_entropy(preds, batch["label"])
    return loss, {"loss": loss,
                  "accuracy": accuracy_metric(preds, batch["label"])}


def resnet_task() -> TrainerTask:
    """Image classification with BatchNorm statistics (``:103-115``):
    ``train=True`` normalises with the batch statistics and updates the
    running ones; ``train=False`` reads them."""

    def forward(model, batch, train=True):
        return model(batch["image"], train=train)

    return TrainerTask("resnet", forward, _image_cls_lam,
                       has_batch_stats=True)


TASKS = {"causal_lm": causal_lm_task, "resnet": resnet_task}


class _CountingIterator:
    """Pass-through iterator that tallies consumed rows."""

    def __init__(self, it):
        self._it = it
        self.rows = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.rows += next(iter(batch.values())).shape[0]
        return batch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Runs the step and the epoch loop for ``model``, whose trainable
    parameters (``CausalLM(..., param_dtype=torch.float32)``, ``ResNet``)
    are the training state's parameters, and whose buffers are its
    ``batch_stats`` when the task has them."""

    def __init__(self, model: torch.nn.Module, task: TrainerTask,
                 learning_rate: float = 1e-3, tx=None,
                 ema_decay: float = 0.0):
        self.model = model
        self.task = task
        self.tx = tx if tx is not None else make_optimizer(learning_rate)
        self.ema_decay = ema_decay
        params = [p for p in model.parameters() if p.requires_grad]
        if not params:
            raise ValueError("the model has no trainable parameters: build "
                             "it with param_dtype=torch.float32")
        self.device = params[0].device

    def init_state(self) -> TrainState:
        params = {name: p for name, p in self.model.named_parameters()
                  if p.requires_grad}
        batch_stats = (dict(self.model.named_buffers())
                       if self.task.has_batch_stats else None)
        return TrainState.create(params, self.tx, batch_stats,
                                 ema_decay=self.ema_decay)

    def _grads(self, batch: Batch):
        """Loss, metrics; leaves the gradients in ``.grad``."""
        preds = self.task.forward(self.model, batch, train=True)
        loss, metrics = self.task.loss_and_metrics(preds, batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _take_grads(state: TrainState, accum: int = 1):
        grads = {}
        for name, p in state.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g if accum == 1 else g / accum
            p.grad = None
        return grads

    def step(self, state: TrainState, batch: Batch):
        """One optimizer step on ``batch`` (device tensors). Returns
        ``(state, metrics)``; metrics are device scalars."""
        metrics = self._grads(batch)
        state.apply_gradients(self._take_grads(state))
        return state, metrics

    def accum_step(self, state: TrainState, batches, accum: int):
        """One optimizer step from ``accum`` consecutive batches: the
        gradients (summed in ``.grad``), metrics and BatchNorm statistics
        are averaged. Every microbatch starts from the same running
        statistics, as in the JAX step."""
        sums: Dict[str, torch.Tensor] = {}
        stats = state.batch_stats or {}
        start = {k: v.clone() for k, v in stats.items()}
        stat_sums = {k: torch.zeros_like(v) for k, v in stats.items()}
        for _ in range(accum):
            for k, v in stats.items():
                v.copy_(start[k])
            metrics = self._grads(next(batches))
            for k, v in stats.items():
                stat_sums[k] += v
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        for k, v in stats.items():
            v.copy_(stat_sums[k] / accum)
        state.apply_gradients(self._take_grads(state, accum))
        return state, {k: v / accum for k, v in sums.items()}

    @torch.no_grad()
    def evaluate(self, state: TrainState, batches,
                 use_ema: bool = False) -> Dict[str, float]:
        """Metrics accumulate as device scalars — one host sync at the
        end. ``use_ema`` evaluates the EMA weights."""
        if use_ema and state.ema_params is None:
            raise ValueError("use_ema=True but the trainer was built with "
                             "ema_decay=0")
        model = self.model
        if use_ema:
            ema = state.ema_params

            def model(*args, **kwargs):  # noqa: F811 — the EMA view
                return functional_call(self.model, ema, args, kwargs)
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = 0
        for batch in batches:
            preds = self.task.forward(model, batch, train=False)
            _, metrics = self.task.loss_and_metrics(preds, batch)
            sums = (metrics if sums is None
                    else {k: sums[k] + v for k, v in metrics.items()})
            count += 1
        if sums is None:
            return {}
        return {k: float(v) / count for k, v in sums.items()}

    def fit(self, state: TrainState, batches, epochs: int,
            steps_per_epoch: int,
            val_batches: Optional[Callable[[], Any]] = None,
            checkpoint_manager=None, heartbeat=None, prefetch: int = 2,
            grad_accum: int = 1,
            val_use_ema: bool = False) -> Tuple[TrainState, Dict[str, list]]:
        """Run the training loop; returns the final state and the
        Keras-style history dict."""
        history: Dict[str, list] = {}
        prefetched = prefetch_to_device(batches, self.device, size=prefetch)
        device_batches = _CountingIterator(prefetched)
        try:
            return self._fit_epochs(
                state, device_batches, epochs, steps_per_epoch, val_batches,
                checkpoint_manager, heartbeat, history, grad_accum, val_use_ema)
        finally:
            # stop the prefetch worker: it must not keep draining the
            # caller's iterator after fit returns or raises
            prefetched.close()

    def _fit_epochs(self, state, device_batches, epochs, steps_per_epoch,
                    val_batches, checkpoint_manager, heartbeat, history,
                    grad_accum, val_use_ema):
        for epoch in range(epochs):
            sums: Dict[str, torch.Tensor] = {}
            t_first_step = 0.0
            epoch_start = time.perf_counter()
            examples = 0
            for step_i in range(steps_per_epoch):
                rows_before = device_batches.rows
                t0 = time.perf_counter()
                if grad_accum > 1:
                    state, metrics = self.accum_step(state, device_batches,
                                                     grad_accum)
                else:
                    state, metrics = self.step(state, next(device_batches))
                if step_i == 0:
                    # the first step absorbs warm-up (kernel build, the
                    # caching allocator, the prefetch fill): keep it out
                    # of the step-time statistics
                    _sync(self.device)
                    t_first_step = time.perf_counter() - t0
                examples += device_batches.rows - rows_before
                if heartbeat is not None:
                    heartbeat.beat(state.step)
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
            sums_host = {k: float(v) for k, v in sums.items()}
            _sync(self.device)
            epoch_time = time.perf_counter() - epoch_start

            for k, v in sums_host.items():
                history.setdefault(k, []).append(v / steps_per_epoch)
            steady_steps = max(steps_per_epoch - 1, 1)
            steady_time = max(epoch_time - t_first_step, 1e-9)
            steady_examples = examples * steady_steps / steps_per_epoch
            step_ms = steady_time / steady_steps * 1000.0
            history.setdefault("step_time_ms", []).append(step_ms)
            history.setdefault("examples_per_sec", []).append(
                steady_examples / steady_time)
            logger.info("Epoch %d/%d - %s - %.1f ms/step", epoch + 1, epochs,
                        " - ".join(f"{k}: {history[k][-1]:.4f}"
                                   for k in sums), step_ms)

            if val_batches is not None:
                val_iter = (put_batch(b, self.device) for b in val_batches())
                val_metrics = self.evaluate(state, val_iter,
                                            use_ema=val_use_ema)
                for k, v in val_metrics.items():
                    history.setdefault(f"val_{k}", []).append(v)
                logger.info("Epoch %d validation - %s", epoch + 1,
                            " - ".join(f"{k}: {v:.4f}"
                                       for k, v in val_metrics.items()))
            if checkpoint_manager is not None:
                checkpoint_manager.maybe_save(state, history)
        return state, history
