"""Liveness, restart-with-resume and transient-failure retries (the
port's copy of ``Heartbeat``, ``run_with_recovery`` and
``retry_with_backoff`` from ``pyspark_tf_gke_tpu/train/resilience.py``).

* :class:`Heartbeat` — an atomically replaced JSON file written from the
  step loop (or the serving driver loop); its age is the liveness
  signal a probe or watchdog reads (:meth:`Heartbeat.is_stalled`).
* :func:`detect_stall` and the watchdog (``python -m
  pyspark_tf_gke_tpu_torch.train.resilience --paths hb0.json --stall
  60``): exit 1 the moment a heartbeat goes stale or never appears
  within the startup grace, 0 when the timeout passes without one;
* :func:`run_with_recovery` — re-enter the training function on failure
  with ``attempt > 0``, so it resumes from the latest checkpoint.
* :func:`retry_with_backoff` — exponential backoff with jitter around an
  idempotent call (bundle loads), each retry counted in
  ``retries_total{op}`` and on the event trail.

The step-loop fault injector lives in ``chaos/inject.py`` and is
re-exported here, as in the JAX module.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Optional, Sequence, TypeVar

from pyspark_tf_gke_tpu_torch.chaos.inject import (  # noqa: F401 — the
    FaultInjector,  # train-plane names, re-exported from the chaos plane
    InjectedFault,
)
from pyspark_tf_gke_tpu_torch.obs.events import get_event_log
from pyspark_tf_gke_tpu_torch.obs.metrics import platform_families
from pyspark_tf_gke_tpu_torch.utils.fs import is_remote
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("train.resilience")

T = TypeVar("T")


class Heartbeat:
    """Step-loop liveness signal: an atomically replaced JSON file.
    ``{process_index}`` in the path becomes the process's rank (0 with
    no ``torch.distributed`` world)."""

    def __init__(self, path: str, every_steps: int = 10):
        if is_remote(path):
            raise ValueError(
                f"heartbeat path must be node-local, got {path!r} — "
                "point HEARTBEAT_FILE at a local path")
        import torch.distributed as dist

        world = dist.is_initialized()
        self.process_index = dist.get_rank() if world else 0
        self.process_count = dist.get_world_size() if world else 1
        self.path = path.replace("{process_index}", str(self.process_index))
        self.every_steps = max(1, every_steps)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)

    def beat(self, step: int, force: bool = False) -> None:
        if not force and step % self.every_steps:
            return
        payload = {"step": int(step), "time": time.time(),
                   "process_index": self.process_index,
                   "process_count": self.process_count}
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

    @staticmethod
    def is_stalled(path: str, stall_seconds: float) -> bool:
        """True when the loop wrote a heartbeat once but has gone quiet.
        A missing file is 'not started', not 'stalled'."""
        a = Heartbeat.age(path)
        return a is not None and a > stall_seconds


def detect_stall(paths: Sequence[str], stall_seconds: float,
                 timeout_s: float, poll_s: float = 0.5,
                 startup_grace_s: Optional[float] = None) -> Optional[str]:
    """Poll the heartbeat files until one goes stale (written once, then
    quiet for ``stall_seconds``) or ``timeout_s`` elapses; returns the
    first stalled path, or None. A file that never appears counts as
    stalled once ``startup_grace_s`` (default ``3 * stall_seconds``: the
    first beat lands after start-up and the kernels' build) has passed
    since the watch began; with ``timeout_s`` below the grace a missing
    file stays 'not started'."""
    grace = (3 * stall_seconds if startup_grace_s is None
             else startup_grace_s)
    start = time.time()
    deadline = start + timeout_s
    while time.time() < deadline:
        for p in paths:
            if Heartbeat.is_stalled(p, stall_seconds):
                return p
            if Heartbeat.age(p) is None and time.time() - start > grace:
                return p  # never appeared within the startup grace
        time.sleep(poll_s)
    return None


def _watch_main(argv=None) -> int:
    """The watchdog's CLI: exit 1 (printing the stalled file, its age and
    its last beat as JSON) the moment a heartbeat goes stale, 0 when
    ``--timeout`` passes without one. Compose with the shell for the
    restart: ``watch ... || restart-the-job``."""
    import argparse

    ap = argparse.ArgumentParser(description="heartbeat stall watchdog")
    ap.add_argument("--paths", required=True,
                    help="comma-separated heartbeat files")
    ap.add_argument("--stall", type=float, default=60.0,
                    help="seconds of heartbeat silence that count as hung")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="give up (exit 0) after this many seconds")
    ap.add_argument("--poll", type=float, default=1.0)
    ap.add_argument("--startup-grace", type=float, default=None,
                    help="seconds a heartbeat file may remain absent "
                         "before 'never started' counts as stalled "
                         "(default 3x --stall)")
    args = ap.parse_args(argv)
    paths = [p for p in args.paths.split(",") if p]
    stalled = detect_stall(paths, args.stall, args.timeout, args.poll,
                           startup_grace_s=args.startup_grace)
    if stalled:
        print(json.dumps({"stalled": stalled,
                          "age_s": Heartbeat.age(stalled),
                          "last": Heartbeat.read(stalled)}))
        return 1
    return 0


def run_with_recovery(
    train_once: Callable[[int], T],
    max_restarts: int = 2,
    retry_delay_s: float = 0.0,
    fatal: Sequence[type] = (KeyboardInterrupt, SystemExit, GeneratorExit),
) -> T:
    """Run ``train_once(attempt)``; on an exception not in ``fatal``,
    restart with ``attempt + 1`` (``train_once`` resumes from its
    checkpoint when ``attempt > 0``) up to ``max_restarts`` times. The
    event trail gets ``retry``, ``recovery_succeeded`` and
    ``recovery_exhausted``, as from the JAX loop."""
    attempt = 0
    while True:
        try:
            result = train_once(attempt)
            if attempt:
                get_event_log().emit("recovery_succeeded", attempt=attempt)
            return result
        except BaseException as e:  # noqa: BLE001 — resilience boundary
            if isinstance(e, tuple(fatal)) or attempt >= max_restarts:
                get_event_log().emit(
                    "recovery_exhausted", attempt=attempt,
                    error=f"{type(e).__name__}: {e}"[:500],
                    fatal=isinstance(e, tuple(fatal)))
                raise
            attempt += 1
            logger.warning(
                "Training attempt %d failed (%s: %s); restarting with resume "
                "(%d/%d)", attempt, type(e).__name__, e, attempt, max_restarts)
            get_event_log().emit(
                "retry", attempt=attempt, max_restarts=max_restarts,
                error=f"{type(e).__name__}: {e}"[:500])
            if retry_delay_s:
                time.sleep(retry_delay_s)


def retry_with_backoff(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay_s: float = 0.1,
    max_delay_s: float = 5.0,
    jitter: float = 0.5,
    retry_on: Sequence[type] = (Exception,),
    give_up_on: Sequence[type] = (),
    op: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
) -> T:
    """Call ``fn()`` with exponential backoff and jitter between
    attempts. ``attempts`` counts calls (3 = up to 2 retries); the delay
    before retry k is ``base_delay_s * 2**(k-1)`` capped at
    ``max_delay_s``, its top ``jitter`` fraction randomized. Exceptions
    outside ``retry_on``, or in ``give_up_on`` (a mistyped path's
    ``FileNotFoundError``), propagate at once. Every retry emits a
    ``retry`` event and increments ``retries_total{op}``; ``sleep`` and
    ``rng`` are injectable for tests."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if not 0 <= jitter <= 1:
        raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    r = rng if rng is not None else random
    retry_on = tuple(retry_on)
    give_up_on = tuple(give_up_on)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — filtered by retry_on
            if (isinstance(exc, give_up_on)
                    or not isinstance(exc, retry_on)
                    or attempt >= attempts):
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** (attempt - 1)))
            delay = delay * (1.0 - jitter) + delay * jitter * r.random()
            platform_families()["retries_total"].labels(op=op).inc()
            get_event_log().emit(
                "retry", op=op, attempt=attempt, max_attempts=attempts,
                delay_s=round(delay, 4),
                error=f"{type(exc).__name__}: {exc}"[:500])
            logger.warning(
                "%s failed (%s: %s); retrying in %.2fs (%d/%d)",
                op, type(exc).__name__, exc, delay, attempt, attempts - 1)
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # the loop returns or raises


if __name__ == "__main__":
    import sys

    sys.exit(_watch_main())
