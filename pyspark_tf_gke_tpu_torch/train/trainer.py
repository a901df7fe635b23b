"""The trainer: train step + epoch loop (counterpart of
``pyspark_tf_gke_tpu/train/trainer.py``: the classification (MLP),
regression (CNN), causal-LM, ResNet, ViT and BERT tasks).

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
  ``step_time_ms``, ``examples_per_sec`` and ``val_*``;
* the loop feeds the metrics registry and the event trail as the JAX
  one does (``obs/``): ``train_fit_start`` and ``train_epoch_end``
  events, the ``train_steps_total``, ``train_examples_total`` and
  ``train_epochs_total`` counters, the ``train_step_time_ms`` histogram
  of each step's host dispatch interval (each epoch's first step left
  out) and the ``train_last_loss`` gauge.

After each step the loop beats the heartbeat, then lets the fault
injector fail the step (chaos tests), then logs every ``log_every``
steps, in the JAX loop's order.

``Trainer(mesh=)`` trains on a ``DeviceMesh`` (``parallel/``), one rank
a card, as the JAX trainer trains on its ``Mesh``: the parameters are
placed by the logical axes the model declares (``fsdp_spec`` for a
model without them, ``fsdp_min_size``), each rank feeds its rows of
every global batch (``batch_sharding``), the losses and metrics are the
global batch's (each task reduces its sums and counts over the data
ranks, counts first), and the optimizer steps sharded state
(``parallel/spmd.py``). The same code runs at every extent, 1
included; ``mesh=None`` is the one-device path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from pyspark_tf_gke_tpu_torch.data.mlm import IGNORE_INDEX
from pyspark_tf_gke_tpu_torch.data.pipeline import prefetch_to_device, put_batch
from pyspark_tf_gke_tpu_torch.obs.events import get_event_log
from pyspark_tf_gke_tpu_torch.obs.metrics import get_registry, platform_families
from pyspark_tf_gke_tpu_torch.ops.chunked_ce import chunked_cross_entropy
from pyspark_tf_gke_tpu_torch.parallel.sharding import (DEFAULT_MIN_SIZE,
                                                        LOGICAL_RULES,
                                                        model_shardings)
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
from pyspark_tf_gke_tpu_torch.train.losses import (accuracy_metric,
                                                   mae_metric, mse_loss,
                                                   per_token_cross_entropy,
                                                   softmax_cross_entropy)
from pyspark_tf_gke_tpu_torch.train.state import TrainState
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.trainer")

Batch = Dict[str, torch.Tensor]


class _Local:
    """The reductions of a task off a mesh: the values are the whole
    batch's already (``parallel.spmd.Spmd`` on a mesh)."""

    @staticmethod
    def sum(x):
        return x

    @staticmethod
    def mean(x):
        return x


LOCAL = _Local()


@dataclasses.dataclass(frozen=True)
class TrainerTask:
    """How a model family plugs into the step: how to call it
    (``forward(model, batch, train=True) -> preds``) and how to score it
    (``loss_and_metrics(preds, batch, reduce=LOCAL) -> (loss,
    metrics)``; ``reduce.sum`` / ``reduce.mean`` take a rank's sum or
    mean to the global batch's on a mesh)."""

    name: str
    forward: Callable[..., Any]
    loss_and_metrics: Callable[[Any, Batch],
                               Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    has_batch_stats: bool = False


def classification_task() -> TrainerTask:
    """The MLP on ``{"x", "y"}``: softmax cross-entropy and accuracy."""

    def forward(model, batch, train=True):
        return model(batch["x"])

    def lam(preds, batch, reduce=LOCAL):
        loss = reduce.mean(softmax_cross_entropy(preds, batch["y"]))
        return loss, {"loss": loss, "accuracy": reduce.mean(
            accuracy_metric(preds, batch["y"]))}

    return TrainerTask("classification", forward, lam)


def regression_task() -> TrainerTask:
    """The CNN regressor on ``{"image", "target"}``: MSE loss, with
    ``mse`` and ``mae``."""

    def forward(model, batch, train=True):
        return model(batch["image"])

    def lam(preds, batch, reduce=LOCAL):
        loss = reduce.mean(mse_loss(preds, batch["target"]))
        return loss, {"loss": loss, "mse": loss, "mae": reduce.mean(
            mae_metric(preds, batch["target"]))}

    return TrainerTask("regression", forward, lam)


def causal_lm_task(vocab_chunks: Optional[int] = None) -> TrainerTask:
    """Next-token prediction: shift-by-one cross entropy over every
    position that has a successor, masked by ``attention_mask`` when the
    batch carries one (the JAX task, ``:184-243``).

    ``vocab_chunks=N`` takes the chunked large-vocab loss
    (``ops/chunked_ce.py``): the forward returns the final norm's output
    and the head's weights, and the loss applies the head in N vocab
    chunks, so ``[B, S, V]`` logits never exist. The head's kernel is
    taken in the compute dtype, as the dense head's product takes it."""

    def _reduce(per_tok, pred_ids, targets, mask, reduce):
        if mask is not None:
            # the global masked mean: ranks' padding differs
            m = mask[:, 1:].float()
            denom = reduce.sum(m.sum()).clamp_min(1.0)
            loss = reduce.sum((per_tok * m).sum()) / denom
            acc = reduce.sum(((pred_ids == targets) * m).sum()) / denom
        else:
            loss = reduce.mean(per_tok.mean())
            acc = reduce.mean((pred_ids == targets).float().mean())
        return loss, {"loss": loss, "next_token_accuracy": acc}

    if vocab_chunks:
        def forward(model, batch, train=True):
            hidden, kernel, bias = model(
                batch["input_ids"].long(),
                segment_ids=batch.get("segment_ids"), return_head=True)
            return {"hidden": hidden, "kernel": kernel, "bias": bias}

        def lam(preds, batch, reduce=LOCAL):
            targets = batch["input_ids"][:, 1:].long()
            h = preds["hidden"][:, :-1]
            b, s1, e = h.shape
            per_tok, amax = chunked_cross_entropy(
                h.reshape(b * s1, e), preds["kernel"], preds["bias"],
                targets.reshape(-1), num_chunks=vocab_chunks)
            return _reduce(per_tok.reshape(b, s1), amax.reshape(b, s1),
                           targets, batch.get("attention_mask"), reduce)

        return TrainerTask("causal_lm", forward, lam)

    def forward(model, batch, train=True):
        return model(batch["input_ids"].long(),
                     segment_ids=batch.get("segment_ids"))

    def lam(logits, batch, reduce=LOCAL):
        targets = batch["input_ids"][:, 1:].long()
        lg = logits[:, :-1].float()
        per_tok = per_token_cross_entropy(lg, targets)
        return _reduce(per_tok, torch.argmax(lg, -1), targets,
                       batch.get("attention_mask"), reduce)

    return TrainerTask("causal_lm", forward, lam)


def _image_cls_lam(preds, batch, reduce=LOCAL):
    loss = reduce.mean(softmax_cross_entropy(preds, batch["label"]))
    return loss, {"loss": loss, "accuracy": reduce.mean(
        accuracy_metric(preds, batch["label"]))}


def resnet_task() -> TrainerTask:
    """Image classification with BatchNorm statistics (``:103-115``):
    ``train=True`` normalises with the batch statistics and updates the
    running ones; ``train=False`` reads them."""

    def forward(model, batch, train=True):
        return model(batch["image"], train=train)

    return TrainerTask("resnet", forward, _image_cls_lam,
                       has_batch_stats=True)


# the JAX trainer's weight of the MoE load-balance loss; a dense model's
# aux loss is 0, so the term only carries the metric
MOE_AUX_WEIGHT = 0.01


def vit_task() -> TrainerTask:
    """Image classification for the ViT (``:118-130``): no BatchNorm
    statistics; the MoE aux loss, when experts are on, joins the loss."""

    def forward(model, batch, train=True):
        return model(batch["image"])

    def lam(preds, batch, reduce=LOCAL):
        loss, metrics = _image_cls_lam(preds["logits"], batch, reduce)
        return _add_moe_aux(loss, metrics, preds)

    return TrainerTask("vit", forward, lam)


def _bert_forward(model, batch, train=True):
    """The forward every BERT objective shares (``:133-140``)."""
    return model(batch["input_ids"], attention_mask=batch.get(
        "attention_mask"), train=train)


def _add_moe_aux(loss, metrics, preds):
    aux = preds.get("aux_loss")
    if aux is not None:
        loss = loss + MOE_AUX_WEIGHT * aux
        metrics["moe_aux_loss"] = aux
    return loss, metrics


def bert_classification_task() -> TrainerTask:
    """Sequence classification on ``cls_logits`` (``:152-160``)."""
    def lam(preds, batch, reduce=LOCAL):
        logits = preds["cls_logits"]
        loss = reduce.mean(softmax_cross_entropy(logits, batch["labels"]))
        metrics = {"loss": loss, "accuracy": reduce.mean(
            accuracy_metric(logits, batch["labels"]))}
        return _add_moe_aux(loss, metrics, preds)

    return TrainerTask("bert_classification", _bert_forward, lam)


def bert_mlm_task() -> TrainerTask:
    """Masked-language-model pretraining (``:163-181``): cross-entropy
    over the masked positions only (labels == ``IGNORE_INDEX``
    elsewhere, ``data/mlm.py``), with ``mlm_accuracy`` and
    ``masked_frac``."""
    def lam(preds, batch, reduce=LOCAL):
        logits = preds["mlm_logits"].float()  # [B, S, V]
        labels = batch["mlm_labels"].long()
        mask = labels != IGNORE_INDEX
        safe = torch.where(mask, labels, 0)
        per_tok = per_token_cross_entropy(logits, safe)
        denom = reduce.sum(mask.sum()).clamp_min(1)
        loss = reduce.sum(torch.where(mask, per_tok, 0.0).sum()) / denom
        acc = reduce.sum(
            (mask & (torch.argmax(logits, -1) == safe)).sum()) / denom
        metrics = {"loss": loss, "mlm_accuracy": acc,
                   "masked_frac": reduce.mean(mask.float().mean())}
        return _add_moe_aux(loss, metrics, preds)

    return TrainerTask("bert_mlm", _bert_forward, lam)


TASKS = {"classification": classification_task,
         "regression": regression_task,
         "causal_lm": causal_lm_task, "resnet": resnet_task,
         "vit": vit_task,
         "bert_classification": bert_classification_task,
         "bert_mlm": bert_mlm_task}


class _CountingIterator:
    """Pass-through iterator that tallies consumed rows (of the global
    batch: a rank's rows times ``scale``, the data shards)."""

    def __init__(self, it, scale: int = 1):
        self._it = it
        self.scale = scale
        self.rows = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)
        self.rows += next(iter(batch.values())).shape[0] * self.scale
        return batch


def _refuse_unported(model: torch.nn.Module, task: TrainerTask,
                     sizes: Dict[str, int]) -> None:
    """The mesh axes this slice does not run raise, naming their item."""
    from pyspark_tf_gke_tpu_torch.models.moe import MoELayer

    if sizes["sp"] > 1 and not task.name.startswith("bert"):
        raise NotImplementedError(
            f"sp={sizes['sp']} runs BERT's ring and Ulysses attention; the "
            f"{task.name} task under sp is not ported to "
            "pyspark_tf_gke_tpu_torch yet (ROADMAP, P11b)")
    for axis, what in (("pp", "the GPipe schedule"),
                       ("ep", "MoE expert parallelism")):
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"{axis}={sizes[axis]} ({what}) is not ported to "
                "pyspark_tf_gke_tpu_torch yet (ROADMAP, P11b)")
    if sizes["sp"] > 1 and any(isinstance(m, MoELayer)
                               for m in model.modules()):
        raise NotImplementedError(
            "MoE under sp > 1 is not ported to pyspark_tf_gke_tpu_torch yet "
            "(ROADMAP, P11b): the capacity and the aux loss's means are "
            "global over the sequence")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Runs the step and the epoch loop for ``model``, whose trainable
    parameters (``CausalLM(..., param_dtype=torch.float32)``, ``ResNet``,
    ``ViTClassifier``, ``BertForPretraining(...,
    param_dtype=torch.float32)``)
    are the training state's parameters, and whose buffers are its
    ``batch_stats`` when the task has them."""

    def __init__(self, model: torch.nn.Module, task: TrainerTask,
                 learning_rate: float = 1e-3, tx=None,
                 ema_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 metrics_registry=None, event_log=None, mesh=None,
                 fsdp_min_size: int = DEFAULT_MIN_SIZE,
                 logical_rules=LOGICAL_RULES):
        self.model = model
        self.task = task
        # mu_dtype: Adam's stored first moment (the JAX trainer's
        # optax.adam(mu_dtype=)); ignored when tx is given, as there
        self.tx = tx if tx is not None else make_optimizer(
            learning_rate, mu_dtype=mu_dtype)
        self.ema_decay = ema_decay
        params = [p for p in model.parameters() if p.requires_grad]
        if not params:
            raise ValueError("the model has no trainable parameters: build "
                             "it with param_dtype=torch.float32")
        self.device = params[0].device
        self.mesh = mesh
        self.spmd = None
        self._reduce = LOCAL
        if mesh is not None:
            from pyspark_tf_gke_tpu_torch.parallel.spmd import Spmd

            self.spmd = Spmd(mesh)
            _refuse_unported(model, task, self.spmd.sizes)
            self._masters = self.spmd.place(model, model_shardings(
                model, mesh, fsdp_min_size, logical_rules))
            self.tx.spmd = self.spmd
            self._reduce = self.spmd
        # the live, scrapable view of the loop (obs/); history stays the
        # artifact
        self.metrics_registry = (metrics_registry if metrics_registry
                                 is not None else get_registry())
        self._obs = platform_families(self.metrics_registry)
        self._event_log = (event_log if event_log is not None
                           else get_event_log())

    def init_state(self) -> TrainState:
        """The state over the model's parameters (on a mesh: over this
        rank's shards of them, ``parallel/spmd.py``)."""
        params = (dict(self._masters) if self.spmd is not None else
                  {name: p for name, p in self.model.named_parameters()
                   if p.requires_grad})
        batch_stats = (dict(self.model.named_buffers())
                       if self.task.has_batch_stats else None)
        state = TrainState.create(params, self.tx, batch_stats,
                                  ema_decay=self.ema_decay)
        state.spmd = self.spmd
        return state

    def local_batch(self, batch):
        """This rank's rows of a global host batch (all of it off a
        mesh)."""
        return self.spmd.local_batch(batch) if self.spmd is not None \
            else batch

    def _grads(self, batch: Batch):
        """Loss, metrics; leaves the gradients in ``.grad``."""
        preds = self.task.forward(self.model, batch, train=True)
        loss, metrics = self.task.loss_and_metrics(preds, batch,
                                                   self._reduce)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def _take_grads(self, state: TrainState, accum: int = 1):
        if self.spmd is not None:
            grads = self.spmd.reduce_grads()
            return grads if accum == 1 else {k: g / accum
                                             for k, g in grads.items()}
        grads = {}
        for name, p in state.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g if accum == 1 else g / accum
            p.grad = None
        return grads

    def _sync_model(self, state: TrainState) -> None:
        """On a mesh, gather the fsdp-split shards into the model."""
        if self.spmd is not None:
            self.spmd.gather(state.params)

    def step(self, state: TrainState, batch: Batch):
        """One optimizer step on ``batch`` (device tensors; a rank's rows
        on a mesh). Returns ``(state, metrics)``; metrics are device
        scalars."""
        self._sync_model(state)
        metrics = self._grads(batch)
        state.apply_gradients(self._take_grads(state))
        return state, metrics

    def accum_step(self, state: TrainState, batches, accum: int):
        """One optimizer step from ``accum`` consecutive batches: the
        gradients (summed in ``.grad``), metrics and BatchNorm statistics
        are averaged. Every microbatch starts from the same running
        statistics, as in the JAX step."""
        sums: Dict[str, torch.Tensor] = {}
        self._sync_model(state)
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
        self._sync_model(state)
        if use_ema:
            ema = state.ema_params
            if self.spmd is not None:
                ema = self.spmd.gather(ema, into={})

            def model(*args, **kwargs):  # noqa: F811 — the EMA view
                return functional_call(self.model, ema, args, kwargs)
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = 0
        for batch in batches:
            preds = self.task.forward(model, batch, train=False)
            _, metrics = self.task.loss_and_metrics(preds, batch,
                                                    self._reduce)
            sums = (metrics if sums is None
                    else {k: sums[k] + v for k, v in metrics.items()})
            count += 1
        if sums is None:
            return {}
        return {k: float(v) / count for k, v in sums.items()}

    def fit(self, state: TrainState, batches, epochs: int,
            steps_per_epoch: int,
            val_batches: Optional[Callable[[], Any]] = None,
            checkpoint_manager=None, log_every: int = 0, heartbeat=None,
            fault_injector=None, prefetch: int = 2, grad_accum: int = 1,
            val_use_ema: bool = False, val_local: bool = False
            ) -> Tuple[TrainState, Dict[str, list]]:
        """Run the training loop; returns the final state and the
        Keras-style history dict. ``fault_injector`` is a
        ``chaos.inject.FaultInjector``; ``log_every`` logs the epoch's
        running mean loss every N steps (a host sync). On a mesh each
        batch of ``batches`` and ``val_batches`` is global and each rank
        keeps its rows; ``val_local`` says the validation batches are
        this rank's already."""
        history: Dict[str, list] = {}
        shard = self.local_batch if self.spmd is not None else None
        prefetched = prefetch_to_device(batches, self.device, size=prefetch,
                                        shard=shard)
        device_batches = _CountingIterator(
            prefetched, self.spmd.sizes["dp"] * self.spmd.sizes["fsdp"]
            if self.spmd is not None else 1)
        try:
            return self._fit_epochs(
                state, device_batches, epochs, steps_per_epoch, val_batches,
                checkpoint_manager, log_every, heartbeat, fault_injector,
                history, grad_accum, val_use_ema, val_local)
        finally:
            # stop the prefetch worker: it must not keep draining the
            # caller's iterator after fit returns or raises
            prefetched.close()

    def _fit_epochs(self, state, device_batches, epochs, steps_per_epoch,
                    val_batches, checkpoint_manager, log_every, heartbeat,
                    fault_injector, history, grad_accum, val_use_ema,
                    val_local):
        global_step = int(state.step)
        self._event_log.emit(
            "train_fit_start", task=self.task.name, epochs=epochs,
            steps_per_epoch=steps_per_epoch, start_step=global_step,
            grad_accum=grad_accum)
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
                step_rows = device_batches.rows - rows_before
                examples += step_rows
                global_step += 1
                # counters take every step; the histogram the steady ones
                # (the host dispatch interval, as in the JAX loop)
                self._obs["train_steps_total"].inc()
                self._obs["train_examples_total"].inc(step_rows)
                if step_i != 0:
                    self._obs["train_step_time_ms"].observe(
                        (time.perf_counter() - t0) * 1000.0)
                if heartbeat is not None:
                    heartbeat.beat(global_step)
                if fault_injector is not None:
                    fault_injector.maybe_fail(global_step)
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
                if log_every and (step_i + 1) % log_every == 0:
                    logger.info(
                        "epoch %d step %d/%d loss=%.4f", epoch + 1,
                        step_i + 1, steps_per_epoch,
                        float(sums.get("loss", 0.0)) / (step_i + 1))
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
            self._obs["train_epochs_total"].inc()
            if "loss" in history:
                self._obs["train_last_loss"].set(history["loss"][-1])
            self._event_log.emit(
                "train_epoch_end", epoch=epoch + 1, global_step=global_step,
                step_time_ms=round(step_ms, 3),
                loss=history.get("loss", [None])[-1])

            if val_batches is not None:
                val_iter = (put_batch(b if val_local else self.local_batch(b),
                                      self.device) for b in val_batches())
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
