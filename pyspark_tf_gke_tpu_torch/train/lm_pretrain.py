"""Causal-LM pretraining entry point: raw text or packed-token shards ->
decoder (counterpart of ``pyspark_tf_gke_tpu/train/lm_pretrain.py``).

``python -m pyspark_tf_gke_tpu_torch.train.lm_pretrain --data-pattern
'corpus/*.txt' [--device cpu] ...`` takes the JAX entry point's flags,
defaults (GPT-small: hidden 768, 12 layers, 12 heads, FFN 3072, seq 512,
global batch 16, byte tokenizer, bf16 compute, Adam at 3e-4) and
``--arch`` preset rules, and writes the same artifacts under
``--output-dir`` (a local directory or an object-store URL):
``history.json``, ``causal-lm.txt``, checkpoints (the port's format;
``--async-checkpoint`` writes them from a background thread) and the
heartbeat (under ``/tmp`` when the output directory is remote).
``--data-format tokens`` reads the text bridge's packed-token shards
(``etl/text_bridge.py``), held to their sidecar; ``--vocab-chunks N``
trains on the chunked large-vocab loss (``ops/chunked_ce.py``);
``--optimizer`` takes every JAX optimizer, lamb and adafactor included.
``--export-bundle`` writes a port serving bundle (EMA weights when
enabled, int8 unless ``--export-dense``). It runs on ``cuda`` unless
``--device cpu``; there the kernels' plain versions run.

The parameters are f32 master weights computed in ``--compute-dtype``,
initialised from a numpy generator seeded with ``--seed`` (the JAX
package draws from ``jax.random``, so the two start from different
numbers). ``--mesh-shape``, ``--dcn-mesh-shape`` and the process
flags (one card a process) lay the run out on a ``DeviceMesh``
(``train/harness.py::setup_mesh``: ``dp``, ``fsdp`` and ``tp``; ``pp``,
``ep`` and ``sp`` raise naming P11b). The batch flags are global: every
rank reads the training stream and keeps its rows of each global
batch. The eval files are split over the data shards as the JAX entry
point splits them over its processes (``len(files)`` must divide
evenly): each rank reads its stripe in batches of its share of
``--batch-size``. A ``--tokenizer`` that is neither ``byte`` nor a
local Hugging Face directory raises ``NotImplementedError`` (a hub name
would need a download).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer, lm_batches
from pyspark_tf_gke_tpu_torch.data.tfrecord import read_tfrecord_batches
from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.etl.text_bridge import validate_shard_meta
from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                       CausalLMConfig,
                                                       init_params)
from pyspark_tf_gke_tpu_torch.train.checkpoint import is_writer
from pyspark_tf_gke_tpu_torch.train.harness import (OPTIMIZERS, finalize_run,
                                                    local_batch_size,
                                                    make_checkpoint,
                                                    make_heartbeat,
                                                    make_optimizer,
                                                    setup_mesh)
from pyspark_tf_gke_tpu_torch.train.resilience import run_with_recovery
from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer
from pyspark_tf_gke_tpu_torch.utils.fs import fs_glob
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.lm_pretrain")


def _env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def parse_args(argv=None) -> argparse.Namespace:
    e = os.environ.get
    p = argparse.ArgumentParser(
        description="Pretrain a decoder-only causal LM on raw text files")
    p.add_argument("--data-pattern", default=e("DATA_PATTERN", ""),
                   help="glob of local text files")
    p.add_argument("--data-format", default=e("DATA_FORMAT", "text"),
                   choices=["text", "tokens"],
                   help="text = raw files tokenized host-side; tokens = "
                        "packed-token TFRecord shards from the text bridge "
                        "(etl/text_bridge.py)")
    p.add_argument("--eval-pattern", default=e("EVAL_PATTERN", ""),
                   help="optional glob of held-out text files; per-epoch "
                        "val_loss and val_perplexity land in history")
    p.add_argument("--eval-batches", type=int,
                   default=int(e("EVAL_BATCHES", "16")))
    p.add_argument("--tokenizer", default=e("TOKENIZER", "byte"),
                   help="'byte' (built-in, vocab 259) or a local Hugging "
                        "Face tokenizer directory (save_pretrained)")
    p.add_argument("--seq-len", type=int, default=int(e("SEQ_LEN", "512")))
    p.add_argument("--hidden-size", type=int,
                   default=int(e("HIDDEN_SIZE", "768")))
    p.add_argument("--num-layers", type=int, default=int(e("NUM_LAYERS", "12")))
    p.add_argument("--num-heads", type=int, default=int(e("NUM_HEADS", "12")))
    p.add_argument("--num-kv-heads", type=int,
                   default=int(e("NUM_KV_HEADS", "0")),
                   help=">0 enables grouped-query attention (1 = MQA)")
    p.add_argument("--kv-cache-quant", action="store_true",
                   default=e("KV_CACHE_QUANT", "") == "1",
                   help="exported bundle serves with an int8 KV cache")
    p.add_argument("--pos-embedding", default=e("POS_EMBEDDING") or None,
                   choices=["learned", "rope"])
    p.add_argument("--norm", default=e("NORM") or None,
                   choices=["layernorm", "rmsnorm"])
    p.add_argument("--ffn", default=e("FFN") or None, choices=["gelu", "swiglu"])
    p.add_argument("--arch", default=e("ARCH", ""),
                   choices=["", "gpt2", "llama"],
                   help="architecture preset: gpt2 = learned+layernorm+gelu "
                        "(the defaults); llama = rope+rmsnorm+swiglu")
    p.add_argument("--doc-masking", action="store_true",
                   default=_env_bool("DOC_MASKING", False),
                   help="confine attention within document boundaries in "
                        "packed rows (segment ids from the packer)")
    p.add_argument("--intermediate-size", type=int,
                   default=int(e("INTERMEDIATE_SIZE", "3072")))
    p.add_argument("--vocab-chunks", type=int,
                   default=int(e("VOCAB_CHUNKS", "0")),
                   help=">0 uses the chunked large-vocab cross-entropy "
                        "(ops/chunked_ce.py) with this many vocab chunks")
    p.add_argument("--remat", action="store_true", default=e("REMAT", "") == "1")
    p.add_argument("--epochs", type=int, default=int(e("EPOCHS", "1")))
    p.add_argument("--steps-per-epoch", type=int,
                   default=int(e("STEPS_PER_EPOCH", "100")))
    p.add_argument("--batch-size", type=int, default=int(e("BATCH_SIZE", "16")),
                   help="GLOBAL batch size")
    p.add_argument("--learning-rate", type=float,
                   default=float(e("LEARNING_RATE", "3e-4")))
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
    p.add_argument("--export-bundle", default=e("EXPORT_BUNDLE", ""),
                   help="directory to export a serving bundle into after "
                        "training (EMA weights if enabled; int8 by default)")
    p.add_argument("--export-dense", action="store_true",
                   default=_env_bool("EXPORT_DENSE", False),
                   help="skip int8 quantization in the exported bundle")
    p.add_argument("--seed", type=int, default=int(e("SEED", "1337")))
    p.add_argument("--mesh-shape", default=e("MESH_SHAPE", ""),
                   help='e.g. "fsdp=2,tp=2"; empty: every rank on dp')
    p.add_argument("--dcn-mesh-shape", default=e("DCN_MESH_SHAPE", ""),
                   help="axes across nodes; --mesh-shape then gives the "
                        "axes within a node")
    p.add_argument("--output-dir", default=e("OUTPUT_DIR", "./lm-pretrain"))
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


def _refuse_unported(args: argparse.Namespace) -> None:
    """Flags the port does not carry raise instead of being ignored."""
    unported = (
        (args.tokenizer not in ("", "byte")
         and not os.path.isdir(args.tokenizer),
         f"--tokenizer {args.tokenizer} (a hub name: only local "
         "save_pretrained directories are read)", "P8 (tokenizer downloads)"),
    )
    for bad, flag, item in unported:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported to pyspark_tf_gke_tpu_torch "
                f"(ROADMAP, queue 1, {item})")


def _resolve_arch(args: argparse.Namespace) -> None:
    """Explicit flags (None = unset) against the ``--arch`` preset; a
    flag that disagrees with the preset is an error."""
    presets = {"llama": {"pos_embedding": "rope", "norm": "rmsnorm",
                         "ffn": "swiglu"},
               "gpt2": {"pos_embedding": "learned", "norm": "layernorm",
                        "ffn": "gelu"},
               "": {}}
    builtin = {"pos_embedding": "learned", "norm": "layernorm", "ffn": "gelu"}
    preset = presets[args.arch]
    for name, default in builtin.items():
        explicit = getattr(args, name)
        if explicit is None:
            setattr(args, name, preset.get(name, default))
        elif name in preset and explicit != preset[name]:
            raise SystemExit(
                f"--arch {args.arch} sets --{name.replace('_', '-')} "
                f"{preset[name]}, conflicting with the explicit "
                f"--{name.replace('_', '-')} {explicit}; drop --arch and "
                "set the architecture flags individually")


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not args.data_pattern:
        raise SystemExit("--data-pattern is required (glob of text files)")
    if args.doc_masking and args.data_format == "tokens":
        raise SystemExit("--doc-masking needs the text data format "
                         "(token shards carry no segment ids)")
    _resolve_arch(args)
    _refuse_unported(args)
    resolve_device(args.device)  # raises before any world or data
    mesh = setup_mesh(args.mesh_shape, args.dcn_mesh_shape,
                      args.num_processes, args.process_id,
                      args.coordinator_addr, args.coordinator_port,
                      args.device)
    device = resolve_device(args.device)  # this rank's card
    logger.info("Causal-LM pretraining: %s on %s", args.data_pattern, device)

    tokenizer = get_tokenizer(args.tokenizer)
    cfg = CausalLMConfig(
        vocab_size=tokenizer.vocab_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        num_kv_heads=args.num_kv_heads or None,
        pos_embedding=args.pos_embedding,
        norm=args.norm,
        ffn=args.ffn,
        intermediate_size=args.intermediate_size,
        max_seq_len=args.seq_len,
        dtype=(torch.bfloat16 if args.compute_dtype == "bfloat16"
               else torch.float32),
        remat=args.remat,
        kv_cache_quant=args.kv_cache_quant,
    )
    with torch.device(device):
        model = CausalLM(cfg, param_dtype=torch.float32)
    model.load_params(init_params(cfg, seed=args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    tx = make_optimizer(
        args.learning_rate, schedule=args.lr_schedule,
        total_steps=args.epochs * args.steps_per_epoch,
        warmup_steps=args.warmup_steps, optimizer=args.optimizer,
        weight_decay=args.weight_decay, grad_clip_norm=args.grad_clip_norm)
    task = TASKS["causal_lm"](vocab_chunks=args.vocab_chunks or None)
    trainer = Trainer(model, task, tx=tx, ema_decay=args.ema_decay,
                      mesh=mesh)
    local_bs = args.batch_size  # every rank reads the global stream
    # the eval stripes: one a data shard, each its share of the batch
    shard_index, shard_count = ((trainer.spmd.batch_index,
                                 trainer.spmd.batch_count)
                                if mesh is not None else (0, 1))
    eval_bs = local_batch_size(args.batch_size, mesh)

    def batches():
        if args.data_format == "tokens":
            validate_shard_meta(args.data_pattern, args.tokenizer,
                                args.seq_len, tokenizer.vocab_size)
            # the reader yields int32 ids
            yield from read_tfrecord_batches(
                args.data_pattern, {"input_ids": ("int", (args.seq_len,))},
                local_bs, seed=args.seed)
            return
        yield from lm_batches(args.data_pattern, tokenizer, args.seq_len,
                              local_bs, seed=args.seed,
                              with_segments=args.doc_masking)

    val_batches = None
    if args.eval_pattern:
        eval_files = fs_glob(args.eval_pattern)
        if not eval_files:
            # fail a typo'd eval path at startup, not after epoch 1
            raise SystemExit(f"--eval-pattern matches no files: "
                             f"{args.eval_pattern!r}")
        if len(eval_files) % shard_count:
            # each data shard evaluates its stripe in collective steps:
            # uneven stripes would desynchronise them (the JAX rule)
            raise SystemExit(
                f"--eval-pattern matched {len(eval_files)} files, which "
                f"does not divide evenly across {shard_count} data "
                "shards; repack the eval set so every shard gets the "
                "same number of files.")

        def val_batches():
            # a fresh unshuffled pass each epoch, capped at
            # --eval-batches, with the training masking
            def gen():
                try:
                    yield from itertools.islice(
                        lm_batches(args.eval_pattern, tokenizer, args.seq_len,
                                   eval_bs, seed=args.seed, repeat=False,
                                   shuffle_buffer=1,
                                   process_index=shard_index,
                                   process_count=shard_count,
                                   with_segments=args.doc_masking),
                        args.eval_batches)
                except ValueError as exc:
                    logger.warning("validation skipped: %s", exc)

            return gen()

    state = trainer.init_state()
    logger.info("Model: %d params (%.1fM), vocab=%d, device=%s", n_params,
                n_params / 1e6, cfg.vocab_size, device)

    def attempt_run(attempt: int) -> dict:
        nonlocal state
        ckpt, state = make_checkpoint(
            args.output_dir, args.checkpoint_every_steps, state,
            args.resume or attempt > 0, async_save=args.async_checkpoint)
        try:
            state, history = trainer.fit(
                state, batches(), args.epochs, args.steps_per_epoch,
                val_batches=val_batches, val_local=mesh is not None,
                # validate the weights the bundle will ship: EMA if enabled
                val_use_ema=args.ema_decay > 0,
                checkpoint_manager=ckpt,
                heartbeat=make_heartbeat(args.output_dir,
                                         args.heartbeat_every_steps,
                                         args.heartbeat_file))
            if "val_loss" in history:
                history["val_perplexity"] = [
                    float(np.exp(min(loss, 30.0)))
                    for loss in history["val_loss"]]
            finalize_run(ckpt, state, history, args.output_dir,
                         model_name="causal-lm")
        finally:
            ckpt.close()
        return history

    history = run_with_recovery(attempt_run, max_restarts=args.max_restarts)
    if args.export_bundle:
        from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle

        weights = (state.ema_params if state.ema_params is not None
                   else state.params)
        if state.spmd is not None:  # every rank gathers, rank 0 writes
            weights = {k: state.spmd.full(t, k) for k, t in weights.items()}
        flat = {name.replace(".", "/"): t.detach().float()
                for name, t in weights.items()}
        if is_writer():
            export_serving_bundle(cfg, flat, args.export_bundle,
                                  quantize=not args.export_dense,
                                  tokenizer_spec=args.tokenizer)
            logger.info("Exported serving bundle to %s", args.export_bundle)
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
