"""BERT fine-tune entry point fed by TFRecord shards (counterpart of
``pyspark_tf_gke_tpu/train/bert_finetune.py``; BASELINE config 5).

``python -m pyspark_tf_gke_tpu_torch.train.bert_finetune --data-pattern
'shards/train-*.tfrecord' [--device cpu] ...`` takes the JAX entry
point's flags and environment defaults (BERT-base: vocab 30522, hidden
768, 12 layers, 12 heads, FFN 3072; seq 128, global batch 32, bf16, Adam
at 2e-5) and writes the same artifacts under ``--output-dir``:
``history.json``, ``bert-finetune.txt``, checkpoints (the port's format)
and the heartbeat. It runs on ``cuda`` unless ``--device cpu``; there
the kernels' plain versions run.

The input contract is the ETL bridge's: one Example per row with
``input_ids`` and ``attention_mask`` int64 features of length
``--seq-len`` and an int64 ``label`` (``--objective mlm`` reads the
first two and masks them, ``data/mlm.py``). The parameters are f32
master weights computed in ``--compute-dtype``, initialised from a numpy
generator seeded with ``--seed`` (the JAX package draws from
``jax.random``). ``--mesh-shape``, ``--dcn-mesh-shape`` and the process
flags (one card a process) lay the run out on a ``DeviceMesh``
(``train/harness.py::setup_mesh``): ``dp``, ``fsdp``, ``tp`` and ``sp``,
whose ranks each hold one sequence block and run the ring or Ulysses
attention (``--sp-impl``) over the mesh's ``sp`` axis; ``pp``, ``ep``
and MoE under ``sp`` raise naming P11c. The batch flags are global:
every rank reads the shard stream and keeps its rows (and, under
``sp``, its sequence block) of each global batch. ``--num-experts N``
turns every ``--moe-every``-th
FFN into an N-expert MoE (``models/moe.py``, top-2, capacity factor
1.25, as the JAX CLI builds it); its load-balance loss is the history's
``moe_aux_loss``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from pyspark_tf_gke_tpu_torch.data.mlm import mlm_batches
from pyspark_tf_gke_tpu_torch.data.tfrecord import read_tfrecord_batches
from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.bert import (BertConfig,
                                                  BertForPretraining,
                                                  init_params)
from pyspark_tf_gke_tpu_torch.train.harness import (OPTIMIZERS, finalize_run,
                                                    local_batch_size,
                                                    make_checkpoint,
                                                    make_heartbeat,
                                                    make_optimizer,
                                                    setup_mesh)
from pyspark_tf_gke_tpu_torch.train.lm_pretrain import _env_bool
from pyspark_tf_gke_tpu_torch.train.resilience import run_with_recovery
from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer
from pyspark_tf_gke_tpu_torch.utils.config import parse_mesh_shape
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.bert_finetune")


def parse_args(argv=None) -> argparse.Namespace:
    e = os.environ.get
    p = argparse.ArgumentParser(
        description="Fine-tune BERT on TFRecord shards produced by the "
                    "Spark ETL bridge")
    p.add_argument("--data-pattern", default=e("DATA_PATTERN", ""),
                   help="glob of local TFRecord shards, e.g. "
                        "'shards/train-*.tfrecord'")
    p.add_argument("--seq-len", type=int, default=int(e("SEQ_LEN", "128")))
    p.add_argument("--objective", default=e("OBJECTIVE", "classification"),
                   choices=["classification", "mlm"],
                   help="classification = fine-tune on the label column; "
                        "mlm = masked-LM pretraining on the token stream")
    p.add_argument("--mlm-prob", type=float,
                   default=float(e("MLM_PROB", "0.15")))
    p.add_argument("--num-labels", type=int,
                   default=int(e("NUM_LABELS", "2")))
    p.add_argument("--vocab-size", type=int,
                   default=int(e("VOCAB_SIZE", "30522")))
    p.add_argument("--hidden-size", type=int,
                   default=int(e("HIDDEN_SIZE", "768")))
    p.add_argument("--num-layers", type=int, default=int(e("NUM_LAYERS", "12")))
    p.add_argument("--num-heads", type=int, default=int(e("NUM_HEADS", "12")))
    p.add_argument("--intermediate-size", type=int,
                   default=int(e("INTERMEDIATE_SIZE", "3072")))
    p.add_argument("--sp-impl", default=e("SP_IMPL", "ring"),
                   choices=["ring", "ulysses"])
    p.add_argument("--num-experts", type=int,
                   default=int(e("NUM_EXPERTS", "0")),
                   help=">0 turns every --moe-every'th FFN into an MoE")
    p.add_argument("--moe-every", type=int, default=int(e("MOE_EVERY", "2")))
    p.add_argument("--remat", action="store_true", default=e("REMAT", "") == "1")
    p.add_argument("--epochs", type=int, default=int(e("EPOCHS", "1")))
    p.add_argument("--steps-per-epoch", type=int,
                   default=int(e("STEPS_PER_EPOCH", "100")))
    p.add_argument("--batch-size", type=int, default=int(e("BATCH_SIZE", "32")),
                   help="GLOBAL batch size")
    p.add_argument("--learning-rate", type=float,
                   default=float(e("LEARNING_RATE", "2e-5")))
    p.add_argument("--ema-decay", type=float, default=float(e("EMA_DECAY", "0")),
                   help=">0 maintains an EMA of params alongside training")
    p.add_argument("--optimizer", default=e("OPTIMIZER", "adam"),
                   choices=list(OPTIMIZERS))
    p.add_argument("--weight-decay", type=float,
                   default=float(e("WEIGHT_DECAY", "0.0")))
    p.add_argument("--lr-schedule", default=e("LR_SCHEDULE", "constant"),
                   choices=["constant", "cosine", "warmup_cosine"])
    p.add_argument("--warmup-steps", type=int,
                   default=int(e("WARMUP_STEPS", "0")))
    p.add_argument("--grad-clip-norm", type=float,
                   default=float(e("GRAD_CLIP_NORM", "0.0")))
    p.add_argument("--seed", type=int, default=int(e("SEED", "1337")))
    p.add_argument("--mesh-shape", default=e("MESH_SHAPE", ""),
                   help='e.g. "dp=2,sp=2"; empty: every rank on dp')
    p.add_argument("--dcn-mesh-shape", default=e("DCN_MESH_SHAPE", ""),
                   help="axes across nodes; --mesh-shape then gives the "
                        "axes within a node")
    p.add_argument("--output-dir", default=e("OUTPUT_DIR", "./bert-finetune"))
    p.add_argument("--checkpoint-every-steps", type=int,
                   default=int(e("CHECKPOINT_EVERY_STEPS", "0")))
    p.add_argument("--async-checkpoint", action="store_true",
                   default=_env_bool("ASYNC_CHECKPOINT", False))
    p.add_argument("--resume", action="store_true",
                   default=_env_bool("RESUME", False))
    p.add_argument("--compute-dtype", default=e("COMPUTE_DTYPE", "bfloat16"),
                   choices=["bfloat16", "float32"])
    p.add_argument("--num-processes", type=int,
                   default=int(e("NUM_PROCESSES", "1")))
    p.add_argument("--process-id", type=int, default=int(e("PROCESS_ID", "-1")))
    p.add_argument("--coordinator-addr", default=e("COORDINATOR_ADDR", ""))
    p.add_argument("--coordinator-port", type=int,
                   default=int(e("COORDINATOR_PORT", "8476")))
    p.add_argument("--max-restarts", type=int,
                   default=int(e("MAX_RESTARTS", "0")))
    p.add_argument("--heartbeat-every-steps", type=int,
                   default=int(e("HEARTBEAT_EVERY_STEPS", "10")))
    p.add_argument("--heartbeat-file", default=e("HEARTBEAT_FILE", ""),
                   help="node-local heartbeat path (default: "
                        "<output-dir>/heartbeat-{process_index}.json)")
    p.add_argument("--device", default=e("DEVICE", "cuda"),
                   help="'cuda' (the default: kernels on the card) or 'cpu' "
                        "(the kernels' plain versions)")
    return p.parse_args(argv)


def shard_schema(seq_len: int) -> dict:
    """The ETL-bridge contract for sequence-classification shards."""
    return {
        "input_ids": ("int", (seq_len,)),
        "attention_mask": ("int", (seq_len,)),
        "label": ("int", ()),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not args.data_pattern:
        raise SystemExit("--data-pattern is required (glob of TFRecord shards)")
    resolve_device(args.device)  # raises before any world or data
    if args.num_experts and parse_mesh_shape(args.mesh_shape).get("sp", 1) > 1:
        raise NotImplementedError(
            "--num-experts under sp > 1 is not ported to "
            "pyspark_tf_gke_tpu_torch yet (ROADMAP, P11c): the capacity and "
            "the aux loss's means are global over the sequence")
    mesh = setup_mesh(args.mesh_shape, args.dcn_mesh_shape,
                      args.num_processes, args.process_id,
                      args.coordinator_addr, args.coordinator_port,
                      args.device, sp_ok=True)
    device = resolve_device(args.device)  # this rank's card
    logger.info("BERT fine-tune: %s on %s", args.data_pattern, device)

    cfg = BertConfig(
        vocab_size=args.vocab_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        intermediate_size=args.intermediate_size,
        max_position_embeddings=max(512, args.seq_len),
        dtype=(torch.bfloat16 if args.compute_dtype == "bfloat16"
               else torch.float32),
        remat=args.remat,
        sp_impl=args.sp_impl,
        num_experts=args.num_experts,
        moe_every=args.moe_every,
    )
    with torch.device(device):
        model = BertForPretraining(cfg, num_labels=args.num_labels,
                                   param_dtype=torch.float32)
    model.load_params(init_params(cfg, args.num_labels, seed=args.seed))
    task = TASKS["bert_mlm" if args.objective == "mlm"
                 else "bert_classification"]()
    tx = make_optimizer(
        args.learning_rate, schedule=args.lr_schedule,
        total_steps=args.epochs * args.steps_per_epoch,
        warmup_steps=args.warmup_steps, optimizer=args.optimizer,
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip_norm)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, task, tx=tx, ema_decay=args.ema_decay,
                      mesh=mesh)
    local_batch_size(args.batch_size, mesh)  # divides over the data shards
    local_bs = args.batch_size  # every rank reads the global stream

    def batches():
        schema = shard_schema(args.seq_len)
        if args.objective == "mlm":
            schema.pop("label")  # token-stream pretraining data is unlabeled
        raw_iter = read_tfrecord_batches(args.data_pattern, schema, local_bs,
                                         seed=args.seed)
        if args.objective == "mlm":
            yield from mlm_batches(raw_iter, args.vocab_size, seed=args.seed,
                                   mask_prob=args.mlm_prob)
            return
        for raw in raw_iter:
            yield {"input_ids": raw["input_ids"],
                   "attention_mask": raw["attention_mask"],
                   "labels": raw["label"].reshape(-1)}

    state = trainer.init_state()
    logger.info("Model: %d params (%.1fM), device=%s", n_params,
                n_params / 1e6, device)

    def attempt_run(attempt: int) -> dict:
        nonlocal state
        ckpt, state = make_checkpoint(
            args.output_dir, args.checkpoint_every_steps, state,
            args.resume or attempt > 0, async_save=args.async_checkpoint)
        try:
            # a fresh stream per attempt: the previous attempt's prefetch
            # may have advanced a shared iterator past unseen batches
            state, history = trainer.fit(
                state, batches(), args.epochs, args.steps_per_epoch,
                checkpoint_manager=ckpt,
                heartbeat=make_heartbeat(args.output_dir,
                                         args.heartbeat_every_steps,
                                         args.heartbeat_file))
            finalize_run(ckpt, state, history, args.output_dir,
                         model_name="bert-finetune")
        finally:
            ckpt.close()
        return history

    return run_with_recovery(attempt_run, max_restarts=args.max_restarts)


if __name__ == "__main__":
    main(sys.argv[1:])
