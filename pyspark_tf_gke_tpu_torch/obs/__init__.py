"""Observability plane (the counterpart of ``pyspark_tf_gke_tpu/obs/``):
the metrics registry, the event trail, request tracing, the runtime
collectors, the exporters and the engine-step telemetry.

* :mod:`~pyspark_tf_gke_tpu_torch.obs.metrics` — thread-safe
  :class:`MetricsRegistry` with labeled Counter/Gauge/Histogram,
  Prometheus text exposition and a JSON snapshot;
* :mod:`~pyspark_tf_gke_tpu_torch.obs.events` — bounded append-only
  JSONL :class:`EventLog` with sequence numbers that resume across
  restarts;
* :mod:`~pyspark_tf_gke_tpu_torch.obs.runtime` — process and torch
  device collectors under the JAX package's ``runtime_`` names;
* :mod:`~pyspark_tf_gke_tpu_torch.obs.export` — the node-exporter
  textfile writer and the ``/metrics``, ``/events``, ``/traces``,
  ``/stepz`` handler logic the server mounts;
* :mod:`~pyspark_tf_gke_tpu_torch.obs.trace` — W3C ``traceparent``
  propagation, contextvar-carried spans and a bounded flight recorder;
* :mod:`~pyspark_tf_gke_tpu_torch.obs.stepstats` — the engine-step
  records behind ``/stepz``.

Every module but ``runtime`` is stdlib-only.
"""

from pyspark_tf_gke_tpu_torch.obs.events import (
    EventLog,
    append_jsonl_line,
    get_event_log,
    set_event_log,
)
from pyspark_tf_gke_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsError,
    MetricsRegistry,
    duplicate_metric_conflicts,
    get_registry,
    platform_families,
    set_registry,
)
from pyspark_tf_gke_tpu_torch.obs.stepstats import (
    StepRecord,
    StepStatsRing,
    flops_per_token,
)
from pyspark_tf_gke_tpu_torch.obs.trace import (
    Span,
    TraceRecorder,
    current_span,
    current_trace_id,
    format_traceparent,
    parse_traceparent,
    use_span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsError",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS_MS",
    "duplicate_metric_conflicts",
    "get_registry",
    "set_registry",
    "platform_families",
    "EventLog",
    "append_jsonl_line",
    "get_event_log",
    "set_event_log",
    "StepRecord",
    "StepStatsRing",
    "flops_per_token",
    "Span",
    "TraceRecorder",
    "current_span",
    "current_trace_id",
    "format_traceparent",
    "parse_traceparent",
    "use_span",
]
