"""Checkpoint / resume (counterpart of
``pyspark_tf_gke_tpu/train/checkpoint.py``), in the port's own format.

Each save writes the FULL training state — step, parameters, optimizer
state, EMA, BatchNorm statistics — as one ``torch.save`` file,
``<directory>/<step>/state.pt``. A local save is staged in a temporary
directory and renamed into place; an object store (``gs://``,
``memory://``) has no atomic rename, so the file is staged under a
temporary key beside ``state.pt`` and moved onto it. A reader never
sees half a checkpoint. Loads use ``weights_only=True`` (tensors,
numbers and strings; no pickled code). The newest ``max_to_keep`` steps
are kept, and ``history.json`` beside them attests to the newest save.

``save`` copies the state to host memory before it returns, so the next
step's in-place optimizer update cannot reach the copy: a CUDA tensor
goes by a ``non_blocking`` copy into a pinned buffer, followed by a CUDA
event on the same stream. ``async_save=True`` then hands the host copy
to one background writer thread, which waits on that event and never
touches a CUDA tensor; ``history.json`` is deferred until the save it
attests to is durable. A new save, ``wait``, ``close`` and ``restore``
join the writer first. Saves retry with backoff (``checkpoint.save``
chaos fires inside the retried closure) and emit ``checkpoint_saved``
or ``checkpoint_scheduled``; a restore retries too (``checkpoint.
restore``) but not a missing checkpoint. The JAX package's orbax
checkpoints are not read.

On a mesh (``state.spmd``) every rank gathers its shards into the full
tensors (a collective), and rank 0 alone writes them: the file is the
one a one-device run writes, sync or async, local or ``memory://``, as
the JAX package's process 0 writes. A restore reads the full state on
every rank and keeps each rank's shards, so a checkpoint resumes onto
any mesh, or onto none. ``history.json``, the label map and the run
notes are rank 0's.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from pyspark_tf_gke_tpu_torch.chaos.inject import chaos_fire
from pyspark_tf_gke_tpu_torch.obs.events import get_event_log
from pyspark_tf_gke_tpu_torch.train.resilience import retry_with_backoff
from pyspark_tf_gke_tpu_torch.utils.fs import (fs_makedirs, fs_write_text,
                                               is_remote)
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.checkpoint")

STATE_FILE = "state.pt"


class _HostCopy:
    """The state's tensors copied to host memory. CUDA tensors go into
    pinned buffers, reused across saves (a new save first joins the
    writer that reads them), and ``ready`` is the CUDA event after the
    copies; CPU tensors are cloned."""

    def __init__(self):
        self._pinned: Dict[str, torch.Tensor] = {}
        self.ready: Optional[torch.cuda.Event] = None

    def copy(self, tree, key: str = ""):
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            if not t.is_cuda:
                return t.clone()
            buf = self._pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[key] = buf
            buf.copy_(t, non_blocking=True)
            if self.ready is None:
                self.ready = torch.cuda.Event()
            return buf
        if isinstance(tree, dict):
            return {k: self.copy(v, f"{key}/{k}") for k, v in tree.items()}
        return tree

    def snapshot(self, state) -> dict:
        self.ready = None
        tree = {"step": int(state.step),
                "params": self.copy(state.params, "params"),
                "opt_state": self.copy(state.opt_state, "opt_state"),
                "ema_params": self.copy(state.ema_params, "ema_params"),
                "batch_stats": self.copy(state.batch_stats, "batch_stats")}
        if self.ready is not None:
            self.ready.record()  # after every copy, on the current stream
        return tree


def is_writer() -> bool:
    """Rank 0 of a world, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _map_tree(tree: dict, spmd, fn: Callable) -> dict:
    """``tree`` (the saved layout) with every parameter-shaped tensor
    passed through ``fn(tensor, name, drop)``; ``drop`` is the leaf
    dimension an Adafactor ``v_row`` / ``v_col`` was reduced over.
    BatchNorm statistics are whole on every rank."""
    from pyspark_tf_gke_tpu_torch.train.harness import _factored_dims

    def leaves(sub, key=None):
        if sub is None:
            return None
        out = {}
        for name, t in sub.items():
            drop = None
            if key in ("v_row", "v_col"):
                d1, d0 = _factored_dims(spmd.shapes[name])
                drop = d0 if key == "v_row" else d1
            out[name] = fn(t, name, drop)
        return out

    opt = {key: leaves(val, key) if isinstance(val, dict) else val
           for key, val in tree["opt_state"].items()}
    return {**tree, "params": leaves(tree["params"]), "opt_state": opt,
            "ema_params": leaves(tree["ema_params"])}


def _state_tree(state) -> dict:
    return {"step": int(state.step), "params": state.params,
            "opt_state": state.opt_state, "ema_params": state.ema_params,
            "batch_stats": state.batch_stats}


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
        # an object-store URL keeps its scheme (abspath would make it a
        # local ./gs:/ directory)
        self.remote = is_remote(directory)
        self.directory = (directory.rstrip("/") if self.remote
                          else os.path.abspath(directory))
        fs_makedirs(self.directory)
        self.every_steps = every_steps
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._host = _HostCopy()
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._inflight_step: Optional[int] = None
        self._pending_history: Optional[Dict] = None

    # -- the store ---------------------------------------------------------

    def _fs(self):
        import fsspec

        fs, _ = fsspec.core.url_to_fs(self.directory)
        return fs

    def _step_path(self, step: int) -> str:
        return f"{self.directory}/{step}"

    def _has_state(self, step_dir: str) -> bool:
        if self.remote:
            return self._fs().exists(f"{step_dir}/{STATE_FILE}")
        return os.path.exists(os.path.join(step_dir, STATE_FILE))

    def all_steps(self) -> List[int]:
        """The steps with a complete ``state.pt`` on the store."""
        if self.remote:
            fs = self._fs()
            names = ([p.rstrip("/").rsplit("/", 1)[-1]
                      for p in fs.ls(self.directory, detail=False)]
                     if fs.exists(self.directory) else [])
        else:
            names = os.listdir(self.directory)
        return sorted(int(n) for n in names if n.isdigit() and
                      self._has_state(self._step_path(int(n))))

    def latest_step(self) -> Optional[int]:
        """The newest step saved or being saved."""
        steps = self.all_steps()
        if self._inflight_step is not None:
            steps.append(self._inflight_step)
        return max(steps) if steps else None

    def _write(self, tree: dict, force: bool) -> None:
        """Write one host copy as ``<step>/state.pt`` (staged, then moved
        into place) and drop the steps past ``max_to_keep``."""
        step = tree["step"]
        final = self._step_path(step)
        if not force and self._has_state(final):
            return
        if self.remote:
            buf = io.BytesIO()
            torch.save(tree, buf)
            fs = self._fs()
            staged = f"{final}/{STATE_FILE}.tmp-{os.getpid()}"
            with fs.open(staged, "wb") as fh:
                fh.write(buf.getvalue())
            fs.mv(staged, f"{final}/{STATE_FILE}")
        else:
            tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tree, os.path.join(tmp, STATE_FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            if self.remote:
                self._fs().rm(self._step_path(old), recursive=True)
            else:
                shutil.rmtree(self._step_path(old), ignore_errors=True)

    def _write_history(self, history: Dict) -> None:
        if is_writer():
            fs_write_text(f"{self.directory}/history.json",
                          json.dumps(history))

    # -- saves -------------------------------------------------------------

    def _join(self) -> None:
        """Join the writer; a failed background save raises here."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            self._inflight_step = None
        if self._writer_error is not None:
            exc, self._writer_error = self._writer_error, None
            raise exc

    def _background_write(self, tree: dict, force: bool) -> None:
        try:
            if self._host.ready is not None:
                self._host.ready.synchronize()
            retry_with_backoff(lambda: self._write(tree, force),
                               op="checkpoint_save")
        except BaseException as exc:  # noqa: BLE001 — raised at _join
            self._writer_error = exc

    def save(self, state: Any, history: Optional[Dict] = None,
             force: bool = False) -> None:
        self._join()  # one save in flight; its pinned buffers are reused
        if self._pending_history is not None:
            # the save it attests to is durable now
            self._write_history(self._pending_history)
            self._pending_history = None
        step = int(state.step)
        if getattr(state, "spmd", None) is not None:
            # every rank gathers (a collective); rank 0 writes
            state = types.SimpleNamespace(**_map_tree(
                _state_tree(state), state.spmd, state.spmd.full))
            if not is_writer():
                return
        # a retry overwrites: the failed attempt may have left a step
        attempt_force = {"force": force}

        def _save():
            chaos_fire("checkpoint.save", step=step)
            force_now = attempt_force["force"]
            attempt_force["force"] = True
            tree = self._host.snapshot(state)
            if self.async_save:
                self._inflight_step = step
                self._writer = threading.Thread(
                    target=self._background_write, args=(tree, force_now),
                    name=f"checkpoint-{step}", daemon=True)
                self._writer.start()
                return
            if self._host.ready is not None:
                self._host.ready.synchronize()
            self._write(tree, force_now)

        retry_with_backoff(_save, op="checkpoint_save")
        if self.async_save:
            # a snapshot (the trainer keeps appending to its history),
            # written once this save is durable
            self._pending_history = (
                None if history is None
                else {k: list(v) if isinstance(v, list) else v
                      for k, v in history.items()})
            logger.info("Scheduled async checkpoint save of step %d to %s",
                        step, self.directory)
            get_event_log().emit("checkpoint_scheduled", step=step,
                                 directory=self.directory)
            return
        if history is not None:
            self._write_history(history)
        logger.info("Saved checkpoint at step %d to %s", step,
                    self.directory)
        get_event_log().emit("checkpoint_saved", step=step,
                             directory=self.directory)

    def wait(self) -> None:
        """Block until the in-flight save is durable, then write the
        deferred ``history.json`` that attests to it."""
        self._join()
        if self._pending_history is not None:
            self._write_history(self._pending_history)
            self._pending_history = None

    def maybe_save(self, state: Any, history: Optional[Dict] = None) -> None:
        """Save when at least ``every_steps`` have elapsed since the last
        save (called at epoch boundaries)."""
        if not self.every_steps:
            return
        due = int(state.step) - (self.latest_step() or 0) >= self.every_steps
        if getattr(state, "spmd", None) is not None:
            # rank 0 sees its own save in flight: its answer holds
            import torch.distributed as dist

            flag = [due]
            dist.broadcast_object_list(flag, src=0)
            due = flag[0]
        if due:
            self.save(state, history)

    def read(self, step: Optional[int] = None) -> Tuple[int, dict]:
        """``(step, saved tree)`` of ``step`` (default the latest): the
        step, ``params``, ``opt_state``, ``ema_params`` and
        ``batch_stats`` as CPU tensors keyed as the state's."""
        self._join()  # a save in flight lands first
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoint found under {self.directory}")
        path = f"{self._step_path(step)}/{STATE_FILE}"

        def _read():
            chaos_fire("checkpoint.restore", step=step)
            if self.remote:
                with self._fs().open(path, "rb") as fh:
                    data = io.BytesIO(fh.read())
                return torch.load(data, map_location="cpu",
                                  weights_only=True)
            return torch.load(path, map_location="cpu", weights_only=True)

        # a pure read: retried on transient faults, not when missing
        return step, retry_with_backoff(_read, op="checkpoint_restore",
                                        give_up_on=(FileNotFoundError,))

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default the latest) into ``state`` in place and
        return it."""
        step, saved = self.read(step)
        spmd = getattr(state, "spmd", None)
        if spmd is not None:  # this rank's shards of the full state
            saved = _map_tree(saved, spmd, spmd.shard)
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
        """Join the in-flight save and flush the deferred history: call
        before another manager writes the same directory."""
        self.wait()


def save_history(output_dir: str, history: Dict) -> str:
    """``history.json`` (Keras-History-compatible; rank 0's)."""
    path = os.path.join(output_dir, "history.json")
    if is_writer():
        fs_write_text(path, json.dumps(history))
    return path


def save_label_map(output_dir: str, vocab) -> str:
    """``label_map.json``, the reference's format: ``{index: label}``
    (rank 0's)."""
    path = os.path.join(output_dir, "label_map.json")
    if is_writer():
        fs_write_text(path, json.dumps(
            {int(i): s for i, s in enumerate(vocab)}, ensure_ascii=False,
            indent=2))
    return path
