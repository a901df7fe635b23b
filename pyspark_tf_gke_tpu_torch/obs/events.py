"""Bounded append-only JSONL event trail.

Metrics answer "how much / how fast"; the event trail answers "what
happened, in what order": checkpoint saved, retry fired, engine
rebuilt, preemption simulated. One line per event, each carrying a
monotonic per-log sequence number (gap-free ordering even when two
events share a wall-clock second) and a UTC timestamp.

Append semantics: one ``write()`` of one ``\\n``-terminated line on an
``O_APPEND`` descriptor — POSIX keeps concurrent appenders from
interleaving mid-line, which is the same guarantee the bench evidence
trail (``tools/bench_history.jsonl``) has always relied on implicitly;
:func:`append_jsonl_line` is that primitive exposed on its own for
bench.py and other out-of-process writers.

Bounded: when the file exceeds ``max_bytes`` it rotates to ``.1``
(one generation — the trail is operational evidence, not archival
storage; ship it somewhere if you need history) so a hot retry loop
can never fill a node disk.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, List, Optional

_SCHEMA_VERSION = 1


def append_jsonl_line(path: str, obj: dict) -> None:
    """Atomically append one JSON object as one line.

    A single ``write`` on an append-mode descriptor: concurrent writers
    (two processes extending the same trail) produce interleaved
    *lines*, never torn ones. Creates parent directories on demand.
    """
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(obj, sort_keys=True) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


class EventLog:
    """Append-only JSONL log of discrete events with rotation.

    Every record carries:

    * ``seq``   — monotonic per-writer sequence number (survives
      rotation; restart re-derives it from the existing file). With
      several processes appending to ONE trail, each writer numbers
      independently — ``(pid, seq)`` is the unique key and ``ts`` the
      cross-writer ordering; within one process ``seq`` is gap-free,
    * ``pid``   — the writing process,
    * ``ts``    — wall-clock UNIX seconds (float),
    * ``kind``  — the event type (``checkpoint_saved``, ``retry``, ...),
    * ``v``     — schema version,
    * caller-provided fields (JSON-serializable).
    """

    def __init__(self, path: str, max_bytes: int = 4 << 20):
        self.path = os.path.abspath(path)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._seq = self._resume_seq()

    def _resume_seq(self) -> int:
        """Continue numbering after the last committed event (a torn
        final line — crash mid-append from a non-atomic writer — is
        skipped, not fatal)."""
        try:
            with open(self.path, "rb") as fh:
                data = fh.read()
        except OSError:
            return 0
        if data and not data.endswith(b"\n"):
            # heal a torn tail: terminate it so the next append starts
            # on its own line instead of gluing onto the fragment
            try:
                with open(self.path, "ab") as fh:
                    fh.write(b"\n")
            except OSError:
                pass
        lines = data.splitlines()
        for raw in reversed(lines):
            try:
                record = json.loads(raw)
            except ValueError:
                continue
            if not isinstance(record, dict):
                continue  # foreign line (bare JSON scalar/array) — skip
            try:
                return int(record.get("seq", 0)) + 1
            except (ValueError, TypeError):
                continue
        return 0

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns the record written."""
        with self._lock:
            record = {"seq": self._seq, "pid": os.getpid(),
                      "ts": time.time(), "v": _SCHEMA_VERSION,
                      "kind": str(kind), **fields}
            self._seq += 1
            self._maybe_rotate_locked()
            try:
                append_jsonl_line(self.path, record)
            except OSError:
                # Best-effort on read-only checkouts: the event trail is
                # observability, and observability must never take the
                # observed system down.
                pass
            return record

    def _maybe_rotate_locked(self) -> None:
        if self.max_bytes <= 0:
            return
        try:
            if os.path.getsize(self.path) < self.max_bytes:
                return
        except OSError:
            return
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass

    # -- reading ---------------------------------------------------------

    def tail(self, n: int = 100) -> List[dict]:
        """Last ``n`` events (current generation only)."""
        return list(read_events(self.path))[-n:]

    def __len__(self) -> int:
        return sum(1 for _ in read_events(self.path))


def read_events(path: str) -> Iterator[dict]:
    """Yield parsed events; malformed lines (torn tail) are skipped."""
    try:
        fh = open(path, "r")
    except OSError:
        return
    with fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            try:
                yield json.loads(raw)
            except ValueError:
                continue


# -- process default event log -----------------------------------------------

_default_lock = threading.Lock()
_default_log: Optional[EventLog] = None


def default_event_path() -> str:
    """Resolved from ``PYSPARK_TF_GKE_TPU_EVENT_TRAIL`` or a per-user
    tmp path (node-local — same stance as the heartbeat file: events
    are per-host operational state, not shared storage)."""
    env = os.environ.get("PYSPARK_TF_GKE_TPU_EVENT_TRAIL", "")
    if env:
        return env
    import tempfile

    return os.path.join(tempfile.gettempdir(),
                        f"pyspark_tf_gke_tpu_events.{os.getuid()}.jsonl")


def get_event_log() -> EventLog:
    """The process-wide event trail (lazily created at
    :func:`default_event_path`)."""
    global _default_log
    with _default_lock:
        if _default_log is None:
            _default_log = EventLog(default_event_path())
        return _default_log


def set_event_log(log: Optional[EventLog]) -> None:
    """Swap the process default (tests point it at tmp_path; None
    resets to lazy re-create)."""
    global _default_log
    with _default_lock:
        _default_log = log
