"""Checkpoint / resume (counterpart of
``pyspark_tf_gke_tpu/train/checkpoint.py``), in the port's own format.

Each save writes the FULL training state — step, parameters, optimizer
state, EMA, BatchNorm statistics — as one ``torch.save`` file,
``<directory>/<step>/state.pt``, staged in a temporary directory and
renamed into place, so a reader
never sees half a checkpoint. Loads use ``weights_only=True`` (tensors,
numbers and strings; no pickled code). The newest ``max_to_keep`` steps
are kept, and every save rewrites ``history.json`` beside them. The JAX
package's orbax checkpoints are not read, and asynchronous saves are
not ported (ROADMAP, P8).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from pyspark_tf_gke_tpu_torch.utils.fs import fs_makedirs, fs_write_text
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.checkpoint")

STATE_FILE = "state.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _copy_into(dst, src, where: str):
    """Copy a loaded tree into the live one, tensor by tensor (in place:
    the model's parameters are the state's tensors)."""
    if isinstance(dst, torch.Tensor):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"checkpoint {where}: shape {tuple(src.shape)} "
                             f"!= {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"checkpoint {where}: keys differ "
                           f"({sorted(set(dst) ^ set(src))[:5]})")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], f"{where}/{k}")
        return dst
    return src


class CheckpointManager:
    def __init__(self, directory: str, every_steps: int = 0,
                 max_to_keep: int = 3, async_save: bool = False):
        if async_save:
            raise NotImplementedError(
                "--async-checkpoint is not ported (ROADMAP, P8): saves are "
                "synchronous")
        fs_makedirs(directory)
        self.directory = os.path.abspath(directory)
        self.every_steps = every_steps
        self.max_to_keep = max_to_keep

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(
                    os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write_history(self, history: Dict) -> None:
        fs_write_text(os.path.join(self.directory, "history.json"),
                      json.dumps(history))

    def save(self, state: Any, history: Optional[Dict] = None,
             force: bool = False) -> None:
        step = int(state.step)
        final = os.path.join(self.directory, str(step))
        if force or not os.path.exists(os.path.join(final, STATE_FILE)):
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save({"step": step,
                        "params": _cpu(state.params),
                        "opt_state": _cpu(state.opt_state),
                        "ema_params": _cpu(state.ema_params),
                        "batch_stats": _cpu(state.batch_stats)},
                       os.path.join(tmp, STATE_FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
            logger.info("Saved checkpoint at step %d to %s", step,
                        self.directory)
        if history is not None:
            self._write_history(history)

    def wait(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def maybe_save(self, state: Any, history: Optional[Dict] = None) -> None:
        """Save when at least ``every_steps`` have elapsed since the last
        save (called at epoch boundaries)."""
        if not self.every_steps:
            return
        if int(state.step) - (self.latest_step() or 0) >= self.every_steps:
            self.save(state, history)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default the latest) into ``state`` in place and
        return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoint found under {self.directory}")
        saved = torch.load(os.path.join(self.directory, str(step),
                                        STATE_FILE),
                           map_location="cpu", weights_only=True)
        _copy_into(state.params, saved["params"], "params")
        state.opt_state = _copy_into(state.opt_state, saved["opt_state"],
                                     "opt_state")
        if (state.ema_params is None) != (saved["ema_params"] is None):
            raise ValueError("checkpoint and state disagree on EMA")
        if state.ema_params is not None:
            _copy_into(state.ema_params, saved["ema_params"], "ema_params")
        saved_stats = saved.get("batch_stats")
        if (state.batch_stats is None) != (saved_stats is None):
            raise ValueError("checkpoint and state disagree on batch_stats")
        if state.batch_stats is not None:
            _copy_into(state.batch_stats, saved_stats, "batch_stats")
        state.step = int(saved["step"])
        logger.info("Restored checkpoint step %d from %s", step,
                    self.directory)
        return state

    def close(self) -> None:
        self.wait()


def save_history(output_dir: str, history: Dict) -> str:
    """``history.json`` (Keras-History-compatible)."""
    return fs_write_text(os.path.join(output_dir, "history.json"),
                         json.dumps(history))
