"""Thread-safe metrics registry: labeled Counter / Gauge / Histogram
with Prometheus text exposition and a JSON snapshot (the counterpart of
``pyspark_tf_gke_tpu/obs/metrics.py``: the same exposition bytes, and
the same family names, help strings, label names and bucket bounds, so
a scraper that reads a JAX replica reads a torch one).

* **Hot-path cheap.** ``inc``/``set``/``observe`` on an unlabeled
  metric is one lock acquire and one float op. Labeled metrics resolve
  their child once and cache the handle.
* **One name, one meaning.** Registering the same name twice with the
  same type/label names returns the EXISTING metric; the same name with
  a different type or label set raises :class:`MetricsError`. Every
  registration is also recorded process-globally
  (:func:`duplicate_metric_conflicts`).
* **Fixed log-scale latency buckets.** Histograms default to
  power-of-2 millisecond buckets spanning 0.25 ms – 64 s.

:func:`platform_families` carries the ``train_`` / ``serve_`` /
``runtime_``-plane families (and ``retries_total``, which
``train/resilience.retry_with_backoff`` counts into);
:func:`chaos_families` the fault-injection counters. The router,
pipeline, replay-client and autopilot families are not ported.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# 0.25ms .. 65536ms in powers of 2 (19 finite buckets + +Inf): log-scale
# so one scheme covers a 40us dispatch and a 60s compile without
# per-metric tuning.
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = tuple(
    0.25 * (2 ** i) for i in range(19)
)

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


class MetricsError(ValueError):
    """Invalid metric name/labels or a conflicting re-registration."""


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST or any(
            c not in _VALID_REST for c in name):
        raise MetricsError(f"invalid metric name {name!r}")
    return name


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# Process-global record of every registration on ANY registry, for the
# duplicate-metric lint (same name, different shape — across registries
# too, since each BundleServer may carry its own registry).
_REG_LOCK = threading.Lock()
_REGISTRATIONS: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}


def _record_registration(name: str, kind: str,
                         labelnames: Tuple[str, ...]) -> None:
    with _REG_LOCK:
        shapes = _REGISTRATIONS.setdefault(name, [])
        if (kind, labelnames) not in shapes:
            shapes.append((kind, labelnames))


def duplicate_metric_conflicts() -> List[str]:
    """Names registered (anywhere in the process) with more than one
    (type, labelnames) shape — the lint ``tools/smoke_check.py`` fails
    on. Empty list = clean."""
    out = []
    with _REG_LOCK:
        for name, shapes in sorted(_REGISTRATIONS.items()):
            if len(shapes) > 1:
                out.append(
                    f"{name}: " + " vs ".join(
                        f"{kind}{list(labels)}" for kind, labels in shapes))
    return out


class _Metric:
    """Common machinery: label-name validation + child management."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}

    def labels(self, *values, **kw) -> "_Metric":
        """Child metric for one label-value combination (handle is
        cached — hold it in hot paths)."""
        if kw:
            if values:
                raise MetricsError("pass label values positionally OR by "
                                   "name, not both")
            try:
                values = tuple(str(kw[ln]) for ln in self.labelnames)
            except KeyError as exc:
                raise MetricsError(
                    f"{self.name}: missing label {exc}") from None
            if len(kw) != len(self.labelnames):
                raise MetricsError(
                    f"{self.name}: unexpected labels "
                    f"{sorted(set(kw) - set(self.labelnames))}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise MetricsError(
                f"{self.name}: got {len(values)} label values for "
                f"{len(self.labelnames)} label names")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                child._labelvalues = values  # type: ignore[attr-defined]
                self._children[values] = child
            return child

    def _make_child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    # -- exposition helpers ---------------------------------------------

    def _series(self) -> List[Tuple[Tuple[str, ...], "_Metric"]]:
        """(labelvalues, leaf) pairs. An unlabeled metric is its own
        single leaf; a labeled one exposes only its children."""
        if not self.labelnames:
            return [((), self)]
        with self._lock:
            return sorted(self._children.items())

    def _label_str(self, values: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(ln, lv) for ln, lv in zip(self.labelnames, values)]
        pairs += list(extra)
        if not pairs:
            return ""
        return ("{" + ",".join(
            f'{ln}="{_escape_label(lv)}"' for ln, lv in pairs) + "}")


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise MetricsError(f"{self.name}: counters only go up "
                               f"(inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _expose(self) -> List[str]:
        return [f"{self.name}{self._label_str(lv)} "
                f"{_format_value(leaf.value)}"
                for lv, leaf in self._series()]

    def _snapshot_one(self):
        return self.value


class Gauge(_Metric):
    """Point-in-time value; optionally backed by a callable collector
    (``set_function``) evaluated at exposition time."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._value = 0.0
        self._fn = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn) -> None:
        """Lazy gauge: ``fn()`` is called at exposition/snapshot time
        (collector pattern — runtime RSS, live-array bytes). A failing
        collector reads 0, never breaks exposition."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 — collectors must never break /metrics
            return 0.0

    def _expose(self) -> List[str]:
        return [f"{self.name}{self._label_str(lv)} "
                f"{_format_value(leaf.value)}"
                for lv, leaf in self._series()]

    def _snapshot_one(self):
        return self.value


def estimate_quantile(buckets: Sequence[float], counts: Sequence[int],
                      q: float) -> Optional[float]:
    """Estimate quantile ``q`` from histogram bucket counts, Prometheus
    ``histogram_quantile`` style: linear interpolation within the
    bucket the target rank lands in (lower bound 0 for the first
    bucket). A rank landing in the +Inf bucket returns the last finite
    upper bound — the honest answer is "at least this". ``counts`` are
    per-bucket (non-cumulative), aligned with ``buckets``; returns
    None when there are no observations."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    for i, (ub, c) in enumerate(zip(buckets, counts)):
        prev_cum = cum
        cum += c
        if cum >= target:
            if ub == math.inf:
                # can't interpolate into an unbounded bucket
                finite = [b for b in buckets if b != math.inf]
                return round(finite[-1], 3) if finite else None
            lo = buckets[i - 1] if i > 0 else 0.0
            if c <= 0:
                return round(ub, 3)
            frac = (target - prev_cum) / c
            return round(lo + (ub - lo) * frac, 3)
    finite = [b for b in buckets if b != math.inf]
    return round(finite[-1], 3) if finite else None


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): ``observe``
    adds to every bucket whose upper bound is >= the value, plus
    ``_sum`` and ``_count`` series. Default buckets are the fixed
    log-scale millisecond ladder."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in (
            buckets if buckets is not None else DEFAULT_LATENCY_BUCKETS_MS)))
        if not bs:
            raise MetricsError(f"{self.name}: histogram needs >= 1 bucket")
        if bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        self._counts = [0] * len(bs)
        self._sum = 0.0
        self._count = 0
        # last exemplar (trace id) per bucket index — JSON snapshot
        # only; the Prometheus text output is unchanged (the 0.0.4
        # text format has no exemplar syntax)
        self._exemplars: Dict[int, str] = {}

    def _make_child(self) -> "Histogram":
        # children share the parent's bucket layout, not the defaults
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        """Record one observation. ``exemplar`` (optional): a trace id
        to remember as this bucket's LAST exemplar — surfaced in the
        JSON snapshot so a latency bucket links to a concrete trace in
        ``GET /traces`` (Prometheus text exposition unchanged)."""
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            # first bucket that holds v; cumulative counts are computed
            # at exposition so the hot path is one increment
            lo, hi = 0, len(self.buckets) - 1
            while lo < hi:
                mid = (lo + hi) // 2
                if v <= self.buckets[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            self._counts[lo] += 1
            if exemplar is not None:
                self._exemplars[lo] = str(exemplar)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _state(self):
        with self._lock:
            return (list(self._counts), self._sum, self._count,
                    dict(self._exemplars))

    def _expose(self) -> List[str]:
        lines: List[str] = []
        for lv, leaf in self._series():
            counts, total, n, _ = leaf._state()
            cum = 0
            for ub, c in zip(leaf.buckets, counts):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._label_str(lv, (('le', _format_value(ub)),))}"
                    f" {cum}")
            lines.append(f"{self.name}_sum{self._label_str(lv)} "
                         f"{_format_value(total)}")
            lines.append(f"{self.name}_count{self._label_str(lv)} {n}")
        return lines

    def _snapshot_one(self):
        counts, total, n, exemplars = self._state()
        out = {"count": n, "sum": total,
               "buckets": {_format_value(ub): c
                           for ub, c in zip(self.buckets, counts)}}
        if n > 0:
            # server-side quantile estimates (bucket interpolation) so
            # /metrics.json consumers stop re-deriving them ad hoc;
            # the Prometheus text exposition is byte-identical
            out["quantiles"] = {
                f"p{int(q * 100)}": estimate_quantile(
                    self.buckets, counts, q)
                for q in (0.5, 0.95, 0.99)}
        if exemplars:
            # per-bucket last trace id (keyed by the bucket's upper
            # bound) — join a tail bucket to its trace in GET /traces
            out["exemplars"] = {
                _format_value(self.buckets[i]): tid
                for i, tid in sorted(exemplars.items())}
        return out


class MetricsRegistry:
    """Holds metrics; hands out idempotent registration and the two
    export formats (Prometheus text, JSON snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    # -- registration ----------------------------------------------------

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str], **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != labelnames):
                    raise MetricsError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{list(existing.labelnames)}, "
                        f"requested {cls.kind}{list(labelnames)}")
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
        # lint bookkeeping (process-global, across registries) — child
        # metrics are not recorded, only top-level registrations
        _record_registration(name, metric.kind, labelnames)
        return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- export ----------------------------------------------------------

    def exposition(self) -> str:
        """Prometheus text format 0.0.4 — ``# HELP``/``# TYPE`` headers
        then the series, families in name order (stable golden
        output)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._expose())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        """JSON-ready dict: name -> value (scalar metrics) or
        {labels: value} / histogram state for labeled ones."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out = {}
        for m in metrics:
            if not m.labelnames:
                out[m.name] = m._snapshot_one()
            else:
                out[m.name] = {
                    ",".join(f"{ln}={lv}"
                             for ln, lv in zip(m.labelnames, values)):
                    leaf._snapshot_one()
                    for values, leaf in m._series()
                }
        return out

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


# -- process default registry ------------------------------------------------

_default_lock = threading.Lock()
_default_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide shared registry: the trainer, the serving
    plane, and the runtime collectors all land here by default so one
    ``/metrics`` scrape correlates all three."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swap the process default (tests install a fresh one so
    observation counts are exact; None resets to lazy re-create)."""
    global _default_registry
    with _default_lock:
        _default_registry = registry


def platform_families(registry: Optional[MetricsRegistry] = None) -> dict:
    """Register (idempotently) the platform's core metric families and
    return their handles by name.

    ONE definition site for the cross-plane names: the trainer and the
    serving front both call this, so ``/metrics`` on either plane
    exposes the full ``train_``/``serve_``/``runtime_`` family set
    (zero-valued until that plane observes something) and the two can
    never drift into conflicting shapes. Runtime collectors are wired
    separately (:func:`pyspark_tf_gke_tpu_torch.obs.runtime
    .install_runtime_metrics`) because they attach live callables.
    """
    r = registry if registry is not None else get_registry()
    return {
        # train plane
        "train_step_time_ms": r.histogram(
            "train_step_time_ms",
            "Steady-step dispatch interval; per-epoch first steps "
            "(compile / queue-drain syncs) are excluded"),
        "train_examples_total": r.counter(
            "train_examples_total",
            "Global training rows consumed"),
        "train_steps_total": r.counter(
            "train_steps_total",
            "Optimizer steps run (includes the compile step)"),
        "train_epochs_total": r.counter(
            "train_epochs_total", "Epochs completed"),
        "train_last_loss": r.gauge(
            "train_last_loss", "Mean loss of the last completed epoch"),
        # serve plane (canonical names; BundleServer.metrics_text keeps
        # the legacy pyspark_tf_gke_tpu_serve_* aliases)
        "serve_requests_total": r.counter(
            "serve_requests_total", "HTTP requests handled"),
        "serve_requests_failed_total": r.counter(
            "serve_requests_failed_total", "HTTP requests failed"),
        "serve_generate_requests_total": r.counter(
            "serve_generate_requests_total", "Generate requests"),
        "serve_generate_tokens_total": r.counter(
            "serve_generate_tokens_total", "New tokens returned"),
        "serve_score_requests_total": r.counter(
            "serve_score_requests_total", "Score requests"),
        "serve_generate_latency_ms": r.histogram(
            "serve_generate_latency_ms",
            "Generate request latency (per HTTP request)"),
        # overload / lifecycle (bounded admission, deadlines, drain)
        "serve_requests_rejected_total": r.counter(
            "serve_requests_rejected_total",
            "Requests shed before any device work",
            labelnames=("reason",)),  # queue_full | deadline | draining
        "serve_request_deadline_exceeded_total": r.counter(
            "serve_request_deadline_exceeded_total",
            "Requests whose client-supplied deadline passed (expired in "
            "queue or cancelled in-slot at a chunk boundary)"),
        "serve_queue_depth": r.gauge(
            "serve_queue_depth",
            "Requests waiting for a KV slot (admission queue)"),
        "serve_draining": r.gauge(
            "serve_draining",
            "1 while the server is draining (SIGTERM received; new "
            "requests get 503)"),
        "retries_total": r.counter(
            "retries_total",
            "Transient-failure retries fired by retry_with_backoff",
            labelnames=("op",)),
        # continuous-batching slot engine
        "serve_slots_total": r.gauge(
            "serve_slots_total", "KV slots in the engine pool"),
        "serve_slots_active": r.gauge(
            "serve_slots_active", "KV slots currently decoding"),
        "serve_useful_tokens_total": r.counter(
            "serve_useful_tokens_total",
            "Tokens decoded into live requests (excludes dead rows)"),
        "serve_engine_rebuilds_total": r.counter(
            "serve_engine_rebuilds_total",
            "Slot-engine rebuilds after a failed device step"),
        "serve_step_watchdog_reaps_total": r.counter(
            "serve_step_watchdog_reaps_total",
            "Step-watchdog interventions: an engine step exceeded "
            "--step-timeout (hung/failed device dispatch), so every "
            "in-flight waiter was failed with an explicit error "
            "terminal and the engine rebuilds when the step returns — "
            "bounded request latency instead of a wedged loop"),
        # chunked prefill / token-level scheduling
        "serve_tbt_ms": r.histogram(
            "serve_tbt_ms",
            "Time between consecutive token deliveries to one request "
            "(a decode chunk lands as one delivery); prefill "
            "head-of-line stalls appear as tail buckets here"),
        "serve_prefill_chunk_tokens": r.histogram(
            "serve_prefill_chunk_tokens",
            "Prompt tokens per chunked-prefill piece (one observation "
            "per piece; whole-prompt admissions don't observe)",
            buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)),
        "serve_prefill_inflight": r.gauge(
            "serve_prefill_inflight",
            "1 while a chunked-prefill admission is mid-flight "
            "(prompt pieces interleaving with decode chunks)"),
        # paged KV cache (engine-managed page pool; zero unless the
        # engine runs a paged model)
        "serve_kv_pages_total": r.gauge(
            "serve_kv_pages_total", "KV page-pool capacity (pages)"),
        "serve_kv_pages_in_use": r.gauge(
            "serve_kv_pages_in_use",
            "KV pages currently allocated to slots"),
        "serve_kv_cache_bytes_per_layer": r.gauge(
            "serve_kv_cache_bytes_per_layer",
            "Bytes of KV cache in use per layer (pages_in_use x page "
            "bytes) — scales with live tokens, not slots x max_len"),
        # radix prefix cache (engine-level trie over the paged KV
        # pool; the dense LRU's hits ride the same counters)
        "serve_prefix_cache_hits_total": r.counter(
            "serve_prefix_cache_hits_total",
            "Admissions that matched a cached prompt prefix (radix "
            "trie over the paged pool, or the dense LRU)"),
        "serve_prefix_cache_hit_tokens_total": r.counter(
            "serve_prefix_cache_hit_tokens_total",
            "Prompt tokens whose prefill was SKIPPED via cached "
            "prefix pages — the prefill-FLOP savings, in tokens"),
        "serve_prefix_cache_pages": r.gauge(
            "serve_prefix_cache_pages",
            "KV pages currently indexed by the radix prefix cache "
            "(trie-resident; evictable when no slot shares them)"),
        "serve_prefix_cache_evictions_total": r.counter(
            "serve_prefix_cache_evictions_total",
            "Cache-resident pages LRU-evicted back to the free list "
            "(pool pressure or resident-page cap)"),
        "serve_kv_page_alloc_failures_total": r.counter(
            "serve_kv_page_alloc_failures_total",
            "Admission attempts deferred because the page pool could "
            "not cover the request (it stays queued)"),
        # disaggregated prefill/decode: KV-page handoff between
        # role-split replicas (zero on mixed-mode fleets)
        "serve_kv_xfer_export_total": r.counter(
            "serve_kv_xfer_export_total",
            "KV-page exports served (prefill side of a disaggregated "
            "handoff: radix-cached pages read back for transfer)"),
        "serve_kv_xfer_export_pages_total": r.counter(
            "serve_kv_xfer_export_pages_total",
            "KV pages exported across all transfers"),
        "serve_kv_xfer_import_total": r.counter(
            "serve_kv_xfer_import_total",
            "KV-page imports installed (decode side: transferred rows "
            "scattered into the pool and adopted into the radix trie)"),
        "serve_kv_xfer_import_pages_total": r.counter(
            "serve_kv_xfer_import_pages_total",
            "KV pages installed from transfers (resident pages are "
            "reused, not re-written)"),
        "serve_kv_xfer_bytes_total": r.counter(
            "serve_kv_xfer_bytes_total",
            "Serialized KV transfer payload bytes, both directions "
            "(the handoff's network cost)"),
        "serve_kv_xfer_failures_total": r.counter(
            "serve_kv_xfer_failures_total",
            "KV transfers that failed (pool exhausted, bad payload, "
            "device error) — the caller falls back to RECOMPUTE"),
        # self-draft speculative decoding (in-slot draft/verify;
        # zero unless the engine runs with --spec-tokens > 0)
        "serve_spec_proposed_total": r.counter(
            "serve_spec_proposed_total",
            "Draft tokens proposed by the speculative decoder "
            "(budget-capped: overshoot rounds past a request's budget "
            "don't count)"),
        "serve_spec_accepted_total": r.counter(
            "serve_spec_accepted_total",
            "Proposed draft tokens the verify pass accepted — each "
            "one is a decode token that skipped its own full-model "
            "forward"),
        "serve_spec_accept_rate": r.gauge(
            "serve_spec_accept_rate",
            "Windowed draft acceptance rate (last 64 spec chunks) — "
            "the /loadz `spec_accept_rate` routing/capacity signal"),
        # multi-tenant fairness / quotas (DWRR admission + per-tenant
        # token buckets; every request carries a tenant — "default"
        # when the client sends none, so single-tenant deployments
        # still populate these families)
        "serve_tenant_requests_total": r.counter(
            "serve_tenant_requests_total",
            "Requests admitted past the tenant quota/share gates, "
            "by tenant",
            labelnames=("tenant",)),
        "serve_tenant_rejected_total": r.counter(
            "serve_tenant_rejected_total",
            "Requests shed PER-TENANT (quota exhausted or queue share "
            "exceeded) — other tenants kept admitting",
            labelnames=("tenant", "reason")),  # tenant_quota |
        #                                        tenant_queue_full
        "serve_tenant_tokens_total": r.counter(
            "serve_tenant_tokens_total",
            "New tokens decoded into each tenant's requests (counted "
            "at delivery, when the unused quota charge refunds)",
            labelnames=("tenant",)),
        "serve_tenant_queue_depth": r.gauge(
            "serve_tenant_queue_depth",
            "Requests waiting for a KV slot, by tenant (the DWRR "
            "subqueue lengths)",
            labelnames=("tenant",)),
        "serve_capacity_free_tokens": r.gauge(
            "serve_capacity_free_tokens",
            "Routable token headroom this replica advertises on "
            "/loadz capacity_free (admission-budget or KV-page bound, "
            "whichever is tighter) — the closed-loop autoscale "
            "signal's per-replica term"),
        # bundle hot-swap (serving side of the continuous pipeline)
        "serve_bundle_generation": r.gauge(
            "serve_bundle_generation",
            "Generation of the bundle currently SERVING traffic — "
            "advances only after a reload's canary generate succeeds "
            "(also on /healthz and /loadz as bundle_generation)"),
        "serve_bundle_reloads_total": r.counter(
            "serve_bundle_reloads_total",
            "POST /admin/reload outcomes: ok (swapped, canary passed) "
            "| rolled_back (bad bundle; previous generation restored) "
            "| rejected (auth/compat/409 — nothing swapped)",
            labelnames=("outcome",)),
        # request tracing (obs/trace.py flight recorder on the serve
        # plane; the retention rate — sampled + slow-captured traces
        # entering the GET /traces ring)
        "serve_traces_recorded_total": r.counter(
            "serve_traces_recorded_total",
            "Traces retained into the serve plane's flight-recorder "
            "ring (sampled, or slower than --trace-slow-ms)"),
        # engine step telemetry (obs/stepstats.py — the ROADMAP item-4
        # host/device decomposition; GET /stepz serves the raw ring)
        "serve_step_host_overhead_ms": r.histogram(
            "serve_step_host_overhead_ms",
            "Per engine step, observed at step close: wall time minus "
            "device-wait — the host (Python bookkeeping) work of the "
            "step. On the pipelined loop (the default) this is a COST "
            "number, not an idle number: host work running under an "
            "in-flight chunk's compute is hidden, and true idle is "
            "the interval-derived serve_device_idle_fraction. "
            "EXCLUDES the deliver phase (amended onto the record "
            "after close) — /stepz and the windowed fractions "
            "include it"),
        "serve_step_phase_ms": r.histogram(
            "serve_step_phase_ms",
            "Per engine step, per phase (expire | schedule | dispatch "
            "| device_wait | collect | deliver): exclusive wall time — "
            "phase sums reconcile with the step wall (pinned by test)",
            labelnames=("phase",)),
        "serve_device_idle_fraction": r.gauge(
            "serve_device_idle_fraction",
            "Windowed fraction of the step-window span with NO chunk "
            "in flight on the device: 1 - union(per-chunk "
            "dispatch->retire intervals)/span over the last ~64 steps "
            "(retire = observed-ready: the is_ready poll at a step "
            "top or the settle's fetch return). Matches the "
            "historical host-work share on a serial loop; splits "
            "below it once the pipeline overlaps host work with "
            "compute — also /loadz step_host_overhead_frac"),
        "serve_mfu": r.gauge(
            "serve_mfu",
            "Windowed model-FLOPs utilization: (decoded + prefilled "
            "tokens)/sec x estimated FLOPs/token / --peak-flops; 0 "
            "when --peak-flops is unset (the CPU default — MFU is "
            "meaningless without the chip's peak)"),
    }


def chaos_families(registry: Optional[MetricsRegistry] = None) -> dict:
    """Register (idempotently) the chaos plane's metric families.

    The fault-injection layer (``pyspark_tf_gke_tpu_torch/chaos/``) counts
    every fired in-process fault and every schedule-driven process
    action here, so a chaos scenario's injections and the recoveries
    they forced (engine rebuilds, reroutes, watchdog reaps) correlate
    on one scrape. Defined here so the whole platform's metric names
    keep one definition site and the duplicate-name lint covers
    them."""
    r = registry if registry is not None else get_registry()
    return {
        "fault_injections_total": r.counter(
            "fault_injections_total",
            "In-process faults fired by the installed ChaosInjector, "
            "by named fault point and action (fail | slow | hang) — "
            "zero in production, where no injector is ever installed",
            labelnames=("point", "action")),
        "chaos_actions_total": r.counter(
            "chaos_actions_total",
            "Process-level chaos-schedule actions executed against a "
            "local fleet (kill | stop | cont | restart) — the "
            "schedule runner's accounting, asserted non-vacuous by "
            "every scenario",
            labelnames=("action",)),
    }
