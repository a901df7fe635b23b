"""Exporters: node-exporter textfile writer + HTTP handler logic (the
counterpart of ``pyspark_tf_gke_tpu/obs/export.py``; the router's
``/fleetz`` and ``/alertz`` routes are not ported).

Two consumption paths for the same registry:

* :class:`TextfileExporter` — writes the Prometheus exposition to a
  ``.prom`` file on an interval thread, atomic-rename style (write a
  sibling temp file, ``os.replace`` in). Point node-exporter's
  ``--collector.textfile.directory`` at the parent directory and
  training jobs get scraped without opening a port — the right shape
  for batch pods behind no Service.
* :func:`handle_obs_request` — the ``/metrics`` + ``/events`` GET
  logic as a transport-free function ``path -> (status, content_type,
  body)``; ``train/serve.py`` mounts it inside its existing
  ``BaseHTTPRequestHandler`` and any future front (gRPC debug page,
  CLI dump) reuses it unchanged.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional, Tuple

from pyspark_tf_gke_tpu_torch.obs.events import EventLog
from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.export")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


def atomic_write_text(path: str, text: str) -> None:
    """Write-then-rename: readers (node-exporter, a human ``cat``)
    never observe a half-written file."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


class TextfileExporter:
    """Interval thread dumping the registry to a ``.prom`` textfile."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 interval_s: float = 15.0):
        self.registry = registry
        self.path = path
        self.interval_s = max(0.1, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write_once(self) -> None:
        atomic_write_text(self.path, self.registry.exposition())

    def start(self) -> "TextfileExporter":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.write_once()
                except OSError as exc:
                    # observability stays best-effort: log and keep the
                    # interval — a full disk must not kill the exporter
                    logger.warning("textfile export failed: %r", exc)
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="obs-textfile-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_write: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_write:
            try:
                self.write_once()
            except OSError:
                pass


def handle_obs_request(
        path: str, registry: MetricsRegistry,
        event_log: Optional[EventLog] = None,
        extra_exposition: str = "",
        tracer=None,
        stepstats=None) -> Optional[Tuple[int, str, bytes]]:
    """GET dispatch for the observability endpoints.

    Returns ``(status, content_type, body)`` for ``/metrics``,
    ``/metrics.json``, ``/events[?n=N]``, (when ``tracer`` — an
    ``obs.trace.TraceRecorder`` — is provided)
    ``/traces[?slow_ms=F&trace_id=HEX&n=N]``, (when ``stepstats``
    — an ``obs.stepstats.StepStatsRing`` — is provided)
    ``/stepz[?n=N&min_ms=F]``, or ``None`` for paths this
    module doesn't own (caller falls through to its own routes).
    ``extra_exposition`` is appended verbatim to ``/metrics`` — the
    serving front uses it for its legacy-name alias block.
    """
    route, _, query = path.partition("?")
    if route == "/metrics":
        text = registry.exposition() + extra_exposition
        return 200, PROMETHEUS_CONTENT_TYPE, text.encode()
    if route == "/metrics.json":
        return 200, "application/json", registry.snapshot_json().encode()
    if route == "/events":
        n = 100
        for part in query.split("&"):
            if part.startswith("n="):
                try:
                    n = max(1, min(int(part[2:]), 10000))
                except ValueError:
                    return (400, "application/json",
                            b'{"error": "n must be an integer"}')
        events = event_log.tail(n) if event_log is not None else []
        body = json.dumps({"events": events,
                           "path": getattr(event_log, "path", None)})
        return 200, "application/json", body.encode()
    if route == "/traces" and tracer is not None:
        slow_ms = trace_id = None
        n = 64
        jsonl = False
        for part in query.split("&"):
            key, _, val = part.partition("=")
            try:
                if key == "slow_ms" and val:
                    slow_ms = float(val)
                elif key == "trace_id" and val:
                    trace_id = val
                elif key == "n" and val:
                    n = max(1, min(int(val), 1024))
                elif key == "format" and val:
                    if val not in ("json", "jsonl"):
                        return (400, "application/json",
                                b'{"error": "format must be json '
                                b'or jsonl"}')
                    jsonl = val == "jsonl"
            except ValueError:
                return (400, "application/json",
                        b'{"error": "bad /traces query parameter"}')
        traces = tracer.traces(slow_ms=slow_ms, trace_id=trace_id,
                               limit=n)
        if jsonl:
            # line-delimited export: one completed trace per line, no
            # envelope — ``tools/replay.py extract`` (and any jq/awk
            # pipeline) streams it line by line instead of loading the
            # whole ring into one JSON document; bounded by ?n= like
            # the JSON form
            body = "".join(json.dumps(t) + "\n" for t in traces)
            return 200, "application/x-ndjson", body.encode()
        body = json.dumps({**tracer.snapshot(), "traces": traces})
        return 200, "application/json", body.encode()
    if route == "/stepz" and stepstats is not None:
        # the step-telemetry ring (obs/stepstats.py): newest-first raw
        # records plus the windowed summary the /loadz fraction and
        # the cb bench's step_phases block derive from. ?min_ms= is
        # the slow-step filter (pair with a /traces slow_ms capture:
        # a slow request, its slow steps, and a profiler window all
        # cross-link through the step seq + trace ids).
        n = 64
        min_ms = None
        for part in query.split("&"):
            key, _, val = part.partition("=")
            try:
                if key == "n" and val:
                    n = max(1, min(int(val), 1024))
                elif key == "min_ms" and val:
                    min_ms = float(val)
            except ValueError:
                return (400, "application/json",
                        b'{"error": "bad /stepz query parameter"}')
        body = json.dumps({"summary": stepstats.summary(),
                           "steps": stepstats.snapshot(n=n,
                                                       min_ms=min_ms)})
        return 200, "application/json", body.encode()
    return None
