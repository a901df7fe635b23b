"""Liveness and restart-with-resume (the port's copy of ``Heartbeat``
and ``run_with_recovery`` from ``pyspark_tf_gke_tpu/train/resilience.py``).

* :class:`Heartbeat` — an atomically replaced JSON file written from the
  step loop; its age is the liveness signal a probe or watchdog reads.
* :func:`run_with_recovery` — re-enter the training function on failure
  with ``attempt > 0``, so it resumes from the latest checkpoint.

The JAX module's event trail, fault injection, stall watchdog and
``retry_with_backoff`` are not ported (ROADMAP, P9).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence, TypeVar

from pyspark_tf_gke_tpu_torch.utils.fs import is_remote
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.resilience")

T = TypeVar("T")


class Heartbeat:
    """Step-loop liveness signal: an atomically replaced JSON file. One
    process, so ``{process_index}`` in the path becomes 0."""

    def __init__(self, path: str, every_steps: int = 10):
        if is_remote(path):
            raise ValueError(
                f"heartbeat path must be node-local, got {path!r} — "
                "point HEARTBEAT_FILE at a local path")
        self.path = path.replace("{process_index}", "0")
        self.every_steps = max(1, every_steps)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)

    def beat(self, step: int, force: bool = False) -> None:
        if not force and step % self.every_steps:
            return
        payload = {"step": int(step), "time": time.time(),
                   "process_index": 0, "process_count": 1}
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, self.path)  # atomic: readers never see a torn file

    @staticmethod
    def read(path: str) -> Optional[dict]:
        try:
            with open(path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    @staticmethod
    def age(path: str) -> Optional[float]:
        """Seconds since the last beat, or None if never beaten."""
        data = Heartbeat.read(path)
        if data is None:
            return None
        return time.time() - float(data["time"])


def run_with_recovery(
    train_once: Callable[[int], T],
    max_restarts: int = 2,
    retry_delay_s: float = 0.0,
    fatal: Sequence[type] = (KeyboardInterrupt, SystemExit, GeneratorExit),
) -> T:
    """Run ``train_once(attempt)``; on an exception not in ``fatal``,
    restart with ``attempt + 1`` (``train_once`` resumes from its
    checkpoint when ``attempt > 0``) up to ``max_restarts`` times."""
    attempt = 0
    while True:
        try:
            return train_once(attempt)
        except BaseException as e:  # noqa: BLE001 — resilience boundary
            if isinstance(e, tuple(fatal)) or attempt >= max_restarts:
                raise
            attempt += 1
            logger.warning(
                "Training attempt %d failed (%s: %s); restarting with resume "
                "(%d/%d)", attempt, type(e).__name__, e, attempt, max_restarts)
            if retry_delay_s:
                time.sleep(retry_delay_s)
