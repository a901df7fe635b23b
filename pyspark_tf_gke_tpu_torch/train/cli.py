"""The reference-parity training entry point (counterpart of
``pyspark_tf_gke_tpu/train/cli.py``):

    python -m pyspark_tf_gke_tpu_torch.train.cli --data-path DATA \\
        --output-dir OUT [--device cpu] ...

* CSV mode (a file): the MLP classifier on the health-CSV schema
  (``data/csv_loader.py``), ``label_map.json`` beside the run;
* image mode (a directory, or ``--data-is-images``): the CNN (x, y)
  regressor (``--flat-layer``: the B1 head) on a flat directory with
  ``clean_labels.jsonl`` (``data/images.py``), in ``--compute-dtype``
  (bf16 by default; the MLP computes in f32, as in the JAX CLI).

Both take the deterministic 80/20 split, write ``history.json``, the run
notes (``mlp.txt``, ``cnn-b1.txt`` or ``cnn-a1.txt``) and checkpoints in
the port's format (the last at the end; periodic with
``--checkpoint-every-steps``), and resume with ``--resume``: the latest
step is restored and the batch order fast-forwarded past the
microbatches it consumed. ``--max-restarts N`` re-enters a failed run
with resume, and ``--fail-at-steps`` injects faults (one injector across
attempts, so a replayed step passes). ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the run (``trace.json``). The run is
on ``cuda`` unless ``--device cpu``. ``--mesh-shape``,
``--dcn-mesh-shape`` and ``--num-processes`` (one card a process) lay
the run out on a ``DeviceMesh`` (``train/harness.py::setup_mesh``;
``dp``, ``fsdp`` and ``tp`` run, the rest raise naming P11b). The batch
flags are global: every rank reads every row and keeps its rows of each
global batch, so a mesh run sees the one-process run's batches; rank 0
writes the artifacts.
The weights start where the JAX CLI's start for the same ``--seed``:
``model.init(jax.random.key(seed), x)``'s parameters, replayed bit for
bit in numpy (``utils/seeding.jax_init_params``).
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.data.csv_loader import load_csv
from pyspark_tf_gke_tpu_torch.data.images import (list_labeled_images,
                                                  make_image_arrays)
from pyspark_tf_gke_tpu_torch.data.pipeline import (BatchIterator,
                                                    train_validation_split)
from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models import build_model
from pyspark_tf_gke_tpu_torch.train.checkpoint import save_label_map
from pyspark_tf_gke_tpu_torch.train.harness import (finalize_run,
                                                    local_batch_size,
                                                    make_checkpoint,
                                                    make_heartbeat,
                                                    make_optimizer,
                                                    setup_mesh)
from pyspark_tf_gke_tpu_torch.train.resilience import (FaultInjector,
                                                       run_with_recovery)
from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer
from pyspark_tf_gke_tpu_torch.utils.config import Config, parse_args
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.cli")


def _dtype(name: str) -> Optional[torch.dtype]:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(name)


def _tx(cfg: Config, steps: int):
    return make_optimizer(
        cfg.learning_rate, cfg.lr_schedule, total_steps=cfg.epochs * steps,
        warmup_steps=cfg.warmup_steps, optimizer=cfg.optimizer,
        weight_decay=cfg.weight_decay, momentum=cfg.momentum,
        grad_clip_norm=cfg.grad_clip_norm)


def _train(cfg: Config, trainer: Trainer, train_iter: BatchIterator,
           steps: int, val_arrays: dict, model_name: str,
           fault_injector: Optional[FaultInjector]) -> dict:
    """Restore (when resuming) and fast-forward, fit, finalise; the
    checkpoint manager is closed however the run ends."""
    local_bs = train_iter.batch_size
    state = trainer.init_state()
    ckpt, state = make_checkpoint(
        cfg.output_dir, cfg.checkpoint_every_steps, state, cfg.resume,
        async_save=cfg.async_checkpoint)
    if state.step:
        # continue the exact batch order from where the restored
        # optimizer step left off (each step took grad_accum microbatches)
        train_iter.fast_forward(state.step * cfg.grad_accum_steps)

    def val_batches():
        if len(next(iter(val_arrays.values()))) < local_bs:
            return
        it = BatchIterator(val_arrays, local_bs, shuffle=False)
        for _ in range(it.steps_per_epoch):
            yield next(it)

    try:
        state, history = trainer.fit(
            state, train_iter, cfg.epochs, steps, val_batches=val_batches,
            checkpoint_manager=ckpt, log_every=cfg.log_every_steps,
            heartbeat=make_heartbeat(cfg.output_dir,
                                     cfg.heartbeat_every_steps,
                                     cfg.heartbeat_file),
            fault_injector=fault_injector, grad_accum=cfg.grad_accum_steps)
        finalize_run(ckpt, state, history, cfg.output_dir,
                     model_name=model_name)
    finally:
        # join an in-flight async save even on failure: a restart builds a
        # fresh manager on this directory, and two writers race
        ckpt.close()
    return history


def run_csv_training(cfg: Config,
                     fault_injector: Optional[FaultInjector] = None,
                     mesh=None) -> dict:
    logger.info("CSV training: %s", cfg.data_path)
    X, y, vocab = load_csv(cfg.data_path)
    num_classes = int(np.max(y)) + 1
    save_label_map(cfg.output_dir, vocab)

    train_idx, val_idx = train_validation_split(len(X), cfg.validation_split,
                                                cfg.seed)
    Xt, yt = X[train_idx], y[train_idx]
    Xv, yv = X[val_idx], y[val_idx]

    if cfg.model not in ("", "mlp"):
        raise ValueError(
            f"CSV mode trains the MLP classifier; got --model {cfg.model}. "
            "ResNet/BERT workloads have dedicated entry points.")

    local_batch_size(cfg.batch_size, mesh)  # divides over the data shards
    train_iter = BatchIterator({"x": Xt, "y": yt}, cfg.batch_size,
                               seed=cfg.seed)
    steps = cfg.steps_per_epoch or train_iter.steps_per_epoch
    # an optimizer step takes grad_accum microbatches: one epoch stays one
    # pass over the data
    steps = -(-steps // cfg.grad_accum_steps)

    model = build_model("mlp", num_classes=num_classes, input_dim=X.shape[1],
                        device=cfg.device, seed=cfg.seed)
    trainer = Trainer(model, TASKS["classification"](), tx=_tx(cfg, steps),
                      mesh=mesh, fsdp_min_size=cfg.fsdp_min_size)
    return _train(cfg, trainer, train_iter, steps, {"x": Xv, "y": yv}, "mlp",
                  fault_injector)


def run_image_training(cfg: Config,
                       fault_injector: Optional[FaultInjector] = None,
                       mesh=None) -> dict:
    logger.info("Image training: %s", cfg.data_path)
    filepaths, _ = list_labeled_images(cfg.data_path)
    train_idx, val_idx = train_validation_split(
        len(filepaths), cfg.validation_split, cfg.seed)
    size = (cfg.img_height, cfg.img_width)
    images_t, targets_t = make_image_arrays(cfg.data_path, size, train_idx)
    images_v, targets_v = make_image_arrays(cfg.data_path, size, val_idx)
    local_batch_size(cfg.batch_size, mesh)  # divides over the data shards
    train_iter = BatchIterator({"image": images_t, "target": targets_t},
                               cfg.batch_size, seed=cfg.seed)
    steps = cfg.steps_per_epoch or train_iter.steps_per_epoch
    steps = -(-steps // cfg.grad_accum_steps)

    if cfg.model not in ("", "cnn"):
        raise ValueError(
            f"Image mode trains the CNN regressor; got --model {cfg.model}. "
            "ResNet/BERT workloads have dedicated entry points.")
    model = build_model("cnn", flat=cfg.flat_layer,
                        dtype=_dtype(cfg.compute_dtype), image_size=size,
                        device=cfg.device, seed=cfg.seed)
    trainer = Trainer(model, TASKS["regression"](), tx=_tx(cfg, steps),
                      mesh=mesh, fsdp_min_size=cfg.fsdp_min_size)
    return _train(cfg, trainer, train_iter, steps,
                  {"image": images_v, "target": targets_v},
                  "cnn-b1" if cfg.flat_layer else "cnn-a1", fault_injector)


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device):
    """A ``torch.profiler`` trace of the block into
    ``profile_dir/trace.json`` (no-op without a directory)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        # the trace is written however the run ends, as jax.profiler's
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def main(argv: Optional[list] = None) -> dict:
    cfg = parse_args(argv)
    resolve_device(cfg.device)  # raises before any world or data
    mesh = setup_mesh(cfg.mesh_shape, cfg.dcn_mesh_shape, cfg.num_processes,
                      cfg.process_id, cfg.coordinator_addr,
                      cfg.coordinator_port, cfg.device)
    device = resolve_device(cfg.device)  # this rank's card
    # one injector across attempts: each injected step fires once, so the
    # replay of that step after the resume goes through
    fault_injector = FaultInjector.from_spec(cfg.fail_at_steps)
    is_image_mode = cfg.data_is_images or os.path.isdir(cfg.data_path)

    def attempt_run(attempt: int) -> dict:
        run_cfg = cfg.replace(resume=cfg.resume or attempt > 0)
        if attempt > 0:
            logger.warning("Restart %d: resuming from latest checkpoint",
                           attempt)
        if is_image_mode:
            return run_image_training(run_cfg, fault_injector, mesh)
        return run_csv_training(run_cfg, fault_injector, mesh)

    with _profiled(cfg.profile_dir, device):
        return run_with_recovery(attempt_run, max_restarts=cfg.max_restarts)


if __name__ == "__main__":
    main(sys.argv[1:])
