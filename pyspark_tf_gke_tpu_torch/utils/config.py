"""Config and flags of the training CLI (the port's copy of
``pyspark_tf_gke_tpu/utils/config.py``): every field has an environment
variable default, and ``parse_args`` takes the JAX CLI's flags with the
same names, choices and defaults, plus ``--device`` (env ``DEVICE``,
default ``cuda``: the card; ``cpu`` runs the plain versions).

``--mesh-shape``, ``--dcn-mesh-shape`` and the process flags
(``--num-processes``, ``--process-id``, ``--coordinator-addr``,
``--coordinator-port``) lay the run out on a ``DeviceMesh`` as the JAX
flags lay it out on a ``Mesh`` (``train/harness.py::setup_mesh``); a
port process drives one card, so ``--num-processes`` counts cards.
``fsdp_min_size`` (env ``FSDP_MIN_SIZE``) is the shape-based
partitioner's threshold. The mesh axes this slice does not run raise
``NotImplementedError`` naming ROADMAP item P11c
(:func:`refuse_unported_axes`): ``pp``, ``ep``, and ``sp`` outside BERT.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Optional, Sequence


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, str(default)))


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "y")


def parse_mesh_shape(spec: str) -> dict:
    """Parse a mesh-shape spec ("dp=4,fsdp=2,tp=1") into an ordered dict.
    Empty segments are skipped; an empty spec yields {}."""
    axes: dict = {}
    if spec:
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, size = part.partition("=")
            axes[name.strip()] = int(size)
    return axes


@dataclasses.dataclass
class Config:
    """All knobs for a training run, each with an env-var default."""

    # --- data ---
    data_path: str = _env("DATA_PATH", "")
    data_is_images: bool = _env_bool("DATA_IS_IMAGES", False)
    img_height: int = _env_int("IMG_HEIGHT", 256)
    img_width: int = _env_int("IMG_WIDTH", 320)
    validation_split: float = _env_float("VALIDATION_SPLIT", 0.2)

    # --- run shape ---
    output_dir: str = _env("OUTPUT_DIR", "./tpu-model")
    epochs: int = _env_int("EPOCHS", 1)
    batch_size: int = _env_int("BATCH_SIZE", 32)  # GLOBAL batch size
    steps_per_epoch: int = _env_int("STEPS_PER_EPOCH", 0)  # 0 → from data
    seed: int = _env_int("SEED", 1337)

    # --- model ---
    model: str = _env("MODEL", "")  # "" = auto by data mode | mlp | cnn
    flat_layer: bool = _env_bool("FLAT_LAYER", False)  # CNN: B1 vs A1 head
    learning_rate: float = _env_float("LEARNING_RATE", 1e-3)
    lr_schedule: str = _env("LR_SCHEDULE", "constant")
    warmup_steps: int = _env_int("WARMUP_STEPS", 0)
    optimizer: str = _env("OPTIMIZER", "adam")
    weight_decay: float = _env_float("WEIGHT_DECAY", 0.0)
    momentum: float = _env_float("MOMENTUM", 0.9)  # --optimizer momentum only
    grad_clip_norm: float = _env_float("GRAD_CLIP_NORM", 0.0)  # 0 → off
    grad_accum_steps: int = _env_int("GRAD_ACCUM_STEPS", 1)
    compute_dtype: str = _env("COMPUTE_DTYPE", "bfloat16")

    # --- parallelism (train/harness.py::setup_mesh) ---
    mesh_shape: str = _env("MESH_SHAPE", "")  # e.g. "dp=2,fsdp=2"
    dcn_mesh_shape: str = _env("DCN_MESH_SHAPE", "")
    fsdp_min_size: int = _env_int("FSDP_MIN_SIZE", 256 << 10 >> 2)
    coordinator_addr: str = _env("COORDINATOR_ADDR", "")
    coordinator_port: int = _env_int("COORDINATOR_PORT", 8476)
    num_processes: int = _env_int("NUM_PROCESSES", 1)
    process_id: int = _env_int("PROCESS_ID", -1)
    device: str = _env("DEVICE", "cuda")

    # --- checkpoint / aux ---
    checkpoint_every_steps: int = _env_int("CHECKPOINT_EVERY_STEPS", 0)
    async_checkpoint: bool = _env_bool("ASYNC_CHECKPOINT", False)
    resume: bool = _env_bool("RESUME", False)
    profile_dir: str = _env("PROFILE_DIR", "")
    log_every_steps: int = _env_int("LOG_EVERY_STEPS", 50)

    # --- resilience (train/resilience.py) ---
    max_restarts: int = _env_int("MAX_RESTARTS", 0)
    heartbeat_every_steps: int = _env_int("HEARTBEAT_EVERY_STEPS", 10)
    heartbeat_file: str = _env("HEARTBEAT_FILE", "")
    fail_at_steps: str = _env("FAIL_AT_STEPS", "")  # chaos: "12,40"

    def mesh_axes(self) -> dict:
        return parse_mesh_shape(self.mesh_shape)

    def dcn_mesh_axes(self) -> dict:
        return parse_mesh_shape(self.dcn_mesh_shape)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)


def refuse_unported_axes(ici: dict, dcn: dict, sp_ok: bool = False) -> None:
    """Raise ``NotImplementedError`` for the mesh axes not ported yet
    (ROADMAP, queue 1, P11c): ``pp`` (the GPipe schedule), ``ep`` (MoE
    expert parallelism) and, unless ``sp_ok`` (BERT), ``sp``."""
    unported = {"pp": "the GPipe schedule", "ep": "MoE expert parallelism"}
    if not sp_ok:
        unported["sp"] = "sequence parallelism outside BERT"
    for axis, what in unported.items():
        size = math.prod(spec.get(axis, 1) for spec in (ici, dcn))
        if size not in (0, 1):
            raise NotImplementedError(
                f"{axis}={size} ({what}) is not ported to "
                "pyspark_tf_gke_tpu_torch yet (ROADMAP, queue 1, P11c)")


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    """The JAX CLI's flags (``--model`` takes the same choices; the
    trainers are ``mlp`` and ``cnn``) and ``--device``."""
    from pyspark_tf_gke_tpu_torch.train.harness import OPTIMIZERS

    cfg = Config()
    p = argparse.ArgumentParser(
        description="Train the MLP (CSV data) or the CNN regressor (an "
                    "image directory) with the PyTorch port")
    p.add_argument("--data-path", default=cfg.data_path,
                   help="CSV file or flat image dir with clean_labels.jsonl")
    p.add_argument("--data-is-images", action="store_true",
                   default=cfg.data_is_images)
    p.add_argument("--img-height", type=int, default=cfg.img_height)
    p.add_argument("--img-width", type=int, default=cfg.img_width)
    p.add_argument("--output-dir", default=cfg.output_dir)
    p.add_argument("--epochs", type=int, default=cfg.epochs)
    p.add_argument("--batch-size", type=int, default=cfg.batch_size,
                   help="GLOBAL batch size")
    p.add_argument("--steps-per-epoch", type=int, default=cfg.steps_per_epoch)
    p.add_argument("--seed", type=int, default=cfg.seed)
    p.add_argument("--model", default=cfg.model,
                   choices=["", "mlp", "cnn", "resnet50", "bert"],
                   help="empty = auto: mlp for CSV data, cnn for image data")
    p.add_argument("--flat-layer", action="store_true",
                   default=cfg.flat_layer)
    p.add_argument("--learning-rate", type=float, default=cfg.learning_rate)
    p.add_argument("--lr-schedule", default=cfg.lr_schedule,
                   choices=["constant", "cosine", "warmup_cosine"])
    p.add_argument("--warmup-steps", type=int, default=cfg.warmup_steps)
    p.add_argument("--optimizer", default=cfg.optimizer,
                   choices=list(OPTIMIZERS))
    p.add_argument("--weight-decay", type=float, default=cfg.weight_decay)
    p.add_argument("--momentum", type=float, default=cfg.momentum)
    p.add_argument("--grad-clip-norm", type=float, default=cfg.grad_clip_norm,
                   help="clip gradients by global norm (0 = off)")
    p.add_argument("--grad-accum-steps", type=int,
                   default=cfg.grad_accum_steps,
                   help="microbatches accumulated per optimizer step")
    p.add_argument("--compute-dtype", default=cfg.compute_dtype)
    p.add_argument("--mesh-shape", default=cfg.mesh_shape,
                   help='e.g. "dp=4,fsdp=2"; empty: every rank on dp '
                        '(no mesh in one process)')
    p.add_argument("--dcn-mesh-shape", default=cfg.dcn_mesh_shape,
                   help='axes across nodes, e.g. "dp=2"; --mesh-shape then '
                        'gives the axes within a node')
    p.add_argument("--coordinator-addr", default=cfg.coordinator_addr)
    p.add_argument("--coordinator-port", type=int,
                   default=cfg.coordinator_port)
    p.add_argument("--num-processes", type=int, default=cfg.num_processes,
                   help="processes of the run, one card each")
    p.add_argument("--process-id", type=int, default=cfg.process_id)
    p.add_argument("--device", default=cfg.device,
                   help="'cuda' (the default: the card) or 'cpu' (the plain "
                        "versions)")
    p.add_argument("--checkpoint-every-steps", type=int,
                   default=cfg.checkpoint_every_steps)
    p.add_argument("--async-checkpoint", action="store_true",
                   default=cfg.async_checkpoint,
                   help="write checkpoints from a background thread")
    p.add_argument("--resume", action="store_true", default=cfg.resume)
    p.add_argument("--profile-dir", default=cfg.profile_dir,
                   help="write a torch.profiler Chrome trace of the run "
                        "here (trace.json)")
    p.add_argument("--max-restarts", type=int, default=cfg.max_restarts,
                   help="in-process restarts with checkpoint resume on "
                        "failure")
    p.add_argument("--heartbeat-every-steps", type=int,
                   default=cfg.heartbeat_every_steps,
                   help="write the liveness heartbeat every N steps (0=off)")
    p.add_argument("--heartbeat-file", default=cfg.heartbeat_file,
                   help="heartbeat path; empty = "
                        "<output-dir>/heartbeat-{process_index}.json")
    p.add_argument("--fail-at-steps", default=cfg.fail_at_steps,
                   help='chaos testing: inject faults at these global '
                        'steps, e.g. "12,40"')
    ns = p.parse_args(argv)
    return cfg.replace(**{k.replace("-", "_"): v for k, v in vars(ns).items()})
