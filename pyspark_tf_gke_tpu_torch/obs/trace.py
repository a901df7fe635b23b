"""End-to-end request tracing: spans, W3C trace-context propagation,
and a bounded flight recorder.

The platform spans four cooperating processes (router → BundleServer →
slot engine, plus the pipeline coordinator publishing into the fleet),
and the metric families in :mod:`~pyspark_tf_gke_tpu_torch.obs.metrics` only
answer aggregate questions — ``serve_tbt_ms`` says *some* request had a
2s token gap, never *which* one or *why*. This module is the
correlation layer (Dapper-style distributed tracing): every hop joins
one 128-bit trace id, carried between processes as the W3C
``traceparent`` header and inside a process by a contextvar, and every
span records wall-timestamped events (queue wait, admission, prefill
pieces, first token, terminal outcome) a human can read back from
``GET /traces``.

Design constraints, in order:

* **Dependency-free.** stdlib only — no jax, no HTTP. The router (a
  jax-free process) and the engine (which must never import HTTP
  machinery) both use it; the engine annotates through a span attached
  to the request object, so it stays transport-blind.
* **Hot-path cheap, overhead bounded.** Sampling decides at the root
  whether a trace RECORDS; an unsampled trace still carries ids (so
  ``X-Request-Id`` and downstream propagation work) but every
  ``event()`` is a single attribute check and return. With sampling
  disabled and no slow capture, tracing short-circuits to
  id-propagation only.
* **Tail latency is never lost.** ``slow_ms`` keeps recording ON for
  every request and applies the filter at RETENTION: a trace whose
  slowest span beats the threshold enters the flight recorder even
  when the sampler said no — the 2s token gap is exactly the trace you
  want, and it is exactly the one uniform sampling misses.
* **Bounded everything.** Completed traces live in a ring
  (``max_traces``); open traces are capped too, so a caller that never
  finishes a span cannot grow memory without bound. Optional JSONL
  export appends retained traces through the same line-atomic
  primitive the event trail uses.

``traceparent`` handling is liberal-in: a malformed or truncated header
mints a NEW root trace — propagation bugs degrade to a broken join,
never to an error a client can see.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple, Union

TRACEPARENT = "traceparent"
_VERSION = "00"
_FLAG_SAMPLED = 0x01
_HEX = set("0123456789abcdef")


def new_trace_id() -> str:
    """Random nonzero 128-bit id as 32 lowercase hex chars."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def new_span_id() -> str:
    """Random nonzero 64-bit id as 16 lowercase hex chars."""
    while True:
        sid = os.urandom(8).hex()
        if sid != "0" * 16:
            return sid


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def parse_traceparent(value) -> Optional[Tuple[str, str, bool]]:
    """Parse a W3C ``traceparent`` header value into
    ``(trace_id, parent_span_id, sampled)``.

    Returns ``None`` for anything malformed — wrong field count, wrong
    lengths, uppercase/non-hex digits, all-zero ids, the forbidden
    ``ff`` version — and the caller mints a new root. Unknown (future)
    versions parse if their first four fields look like version 00,
    per the spec's forward-compatibility rule."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if version == _VERSION and len(parts) != 4:
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) or span_id == "0" * 16:
        return None
    if len(flags) != 2 or not _is_hex(flags):
        return None
    return trace_id, span_id, bool(int(flags, 16) & _FLAG_SAMPLED)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return (f"{_VERSION}-{trace_id}-{span_id}-"
            f"{_FLAG_SAMPLED if sampled else 0:02x}")


class Span:
    """One timed operation within a trace.

    ``recording`` False (unsampled, recorder disabled) keeps the ids —
    propagation and ``X-Request-Id`` echoing still work — while
    ``event``/``set``/``finish`` reduce to attribute checks. Events are
    wall-timestamped dicts appended by whichever thread holds the span
    (the engine driver thread appends while the HTTP thread waits; the
    GIL makes list.append safe, and the span is read only after
    ``finish``)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "sampled",
                 "recording", "start", "end", "attrs", "events",
                 "recorder", "_finished")

    def __init__(self, recorder: Optional["TraceRecorder"], name: str,
                 trace_id: str, span_id: str, parent_id: Optional[str],
                 sampled: bool, recording: bool,
                 attrs: Optional[dict] = None):
        self.recorder = recorder
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.recording = recording
        self.start = time.time()
        self.end: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.events: List[dict] = []
        self._finished = False

    # -- recording --------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Append one timestamped event (no-op when not recording)."""
        if not self.recording:
            return
        if len(self.events) >= _MAX_EVENTS_PER_SPAN:
            return  # bounded: a runaway token loop can't grow one span
            #         without bound (the tail is the interesting part
            #         anyway — attrs carry the totals)
        self.events.append({"name": str(name), "ts": time.time(),
                            **fields})

    def set(self, key: str, value) -> None:
        if self.recording:
            self.attrs[str(key)] = value

    def finish(self, status: Optional[str] = None) -> None:
        """Close the span (idempotent) and hand it to the recorder."""
        if self._finished:
            return
        self._finished = True
        self.end = time.time()
        if status is not None and self.recording:
            self.attrs["status"] = status
        if self.recorder is not None:
            self.recorder._finish(self)

    # -- propagation ------------------------------------------------------

    def traceparent(self) -> str:
        """This span's context as an outgoing ``traceparent`` value."""
        return format_traceparent(self.trace_id, self.span_id,
                                  self.sampled)

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.time()
        return max(0.0, (end - self.start) * 1000.0)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(self.duration_ms, 3),
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }

    # context-manager sugar: ``with recorder.start_span(...) as sp``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and self.recording:
            self.attrs.setdefault(
                "status", f"error:{getattr(exc_type, '__name__', exc_type)}")
        self.finish()


_MAX_EVENTS_PER_SPAN = 512


class TraceRecorder:
    """Span factory + flight recorder (the bounded ring of completed
    traces ``GET /traces`` serves).

    ``sample`` in [0, 1] decides at each locally-minted root whether
    the trace records (an incoming ``traceparent`` with the sampled
    flag set records regardless — the upstream hop already decided).
    ``slow_ms`` > 0 keeps recording ON for everything and retains
    unsampled traces only when their slowest span beats the threshold.
    ``sample == 0 and slow_ms == 0`` disables recording entirely:
    spans still mint/propagate ids, nothing else happens.

    Retained traces land in a ring of ``max_traces``; ``jsonl_path``
    additionally appends each retained trace as one JSONL line (the
    event-trail append primitive — line-atomic, best-effort).
    ``counter`` (an obs Counter, optional) increments per retained
    trace so the plane's retention rate is scrapable."""

    def __init__(self, sample: float = 1.0, slow_ms: float = 0.0,
                 max_traces: int = 256, jsonl_path: Optional[str] = None,
                 counter=None):
        self.sample = min(1.0, max(0.0, float(sample)))
        self.slow_ms = max(0.0, float(slow_ms))
        self.max_traces = max(1, int(max_traces))
        self.jsonl_path = jsonl_path
        self.counter = counter
        self._lock = threading.Lock()
        # trace_id -> {"open": n, "spans": [span dicts], "sampled": bool}
        self._live: "OrderedDict[str, dict]" = OrderedDict()
        self._ring: "deque[dict]" = deque(maxlen=self.max_traces)

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0 or self.slow_ms > 0.0

    # -- span creation ----------------------------------------------------

    def start_span(self, name: str,
                   parent: Union[None, str, Span] = None,
                   attrs: Optional[dict] = None) -> Span:
        """Open a span.

        ``parent`` is one of: an in-process :class:`Span` (child
        inherits its trace + recording decision), an incoming
        ``traceparent`` header value (malformed/truncated → a NEW root,
        never an error), or None (new root; the sampler decides)."""
        if isinstance(parent, Span):
            span = Span(self, name, parent.trace_id, new_span_id(),
                        parent.span_id, parent.sampled,
                        parent.recording and self.enabled, attrs)
        else:
            ctx = parse_traceparent(parent) if parent is not None else None
            if ctx is not None:
                trace_id, parent_id, flag = ctx
                sampled = flag  # upstream's decision propagates
            else:
                trace_id, parent_id = new_trace_id(), None
                sampled = (self.sample > 0.0
                           and random.random() < self.sample)
            recording = self.enabled and (sampled or self.slow_ms > 0.0)
            span = Span(self, name, trace_id, new_span_id(), parent_id,
                        sampled, recording, attrs)
        if span.recording:
            with self._lock:
                entry = self._live.get(span.trace_id)
                if entry is None:
                    entry = {"open": 0, "spans": [],
                             "sampled": span.sampled}
                    self._live[span.trace_id] = entry
                    # bound OPEN traces too: a span never finished must
                    # not leak — evict the oldest abandoned trace
                    while len(self._live) > 4 * self.max_traces:
                        self._live.popitem(last=False)
                entry["open"] += 1
        return span

    # -- completion / retention -------------------------------------------

    def _finish(self, span: Span) -> None:
        if not span.recording:
            return
        with self._lock:
            entry = self._live.get(span.trace_id)
            if entry is None:
                return  # evicted while open (abandoned-trace bound)
            entry["spans"].append(span.to_dict())
            entry["open"] -= 1
            if entry["open"] > 0:
                return
            del self._live[span.trace_id]
            slowest = max(s["duration_ms"] for s in entry["spans"])
            retain = entry["sampled"] or (
                self.slow_ms > 0.0 and slowest >= self.slow_ms)
            if not retain:
                return
            trace = {
                "trace_id": span.trace_id,
                "duration_ms": round(slowest, 3),
                "sampled": entry["sampled"],
                "spans": entry["spans"],
            }
            self._ring.append(trace)
        if self.counter is not None:
            try:
                self.counter.inc()
            except Exception:  # noqa: BLE001 — observability of the
                pass           # observability must never raise
        if self.jsonl_path:
            try:
                from pyspark_tf_gke_tpu_torch.obs.events import append_jsonl_line

                append_jsonl_line(self.jsonl_path, trace)
            except OSError:
                pass  # best-effort, same stance as the event trail

    # -- reading (GET /traces) --------------------------------------------

    def traces(self, slow_ms: Optional[float] = None,
               trace_id: Optional[str] = None,
               limit: int = 64) -> List[dict]:
        """Recent retained traces, newest last. ``slow_ms`` filters to
        traces at least that slow; ``trace_id`` to one trace."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [t for t in out if t["trace_id"] == trace_id]
        if slow_ms is not None:
            out = [t for t in out if t["duration_ms"] >= float(slow_ms)]
        return out[-max(1, int(limit)):]

    def snapshot(self) -> dict:
        """The ``GET /traces`` response body."""
        return {
            "enabled": self.enabled,
            "sample": self.sample,
            "slow_ms": self.slow_ms,
            "max_traces": self.max_traces,
        }


# -- contextvar-carried current span -----------------------------------------

_current_span: "contextvars.ContextVar[Optional[Span]]" = (
    contextvars.ContextVar("pyspark_tf_gke_tpu_current_span",
                           default=None))


def current_span() -> Optional[Span]:
    """The span active on THIS thread/context (None outside a trace)."""
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    span = _current_span.get()
    return span.trace_id if span is not None else None


@contextlib.contextmanager
def use_span(span: Optional[Span]):
    """Make ``span`` the current span for the enclosed block (None is
    allowed and simply yields — callers need no conditional)."""
    if span is None:
        yield None
        return
    token = _current_span.set(span)
    try:
        yield span
    finally:
        _current_span.reset(token)


# -- request-shape annotation (the replay-extraction contract) ----------------

# The attribute key set replay extraction reads off a request's span
# (pyspark_tf_gke_tpu/replay/extract.py; pinned by test so the
# contract can't silently rot): every submitted request carries these
# three, plus deadline_ms when the client sent a deadline. ONE
# definition site — the engine, the serve front and the extractor all
# import it from here.
REQUEST_SHAPE_ATTRS = ("tenant", "prompt_tokens", "max_new_tokens")
REQUEST_SHAPE_OPTIONAL_ATTRS = ("deadline_ms",)


def annotate_request_shape(span: Optional[Span], *, tenant,
                           prompt_tokens, max_new_tokens,
                           deadline_s=None) -> None:
    """Stamp the request SHAPE — everything a workload spec needs —
    onto the request's span. Called by the serve front BEFORE the
    admission gates (a shed request is still demand the capacity
    planner must see) and by the engine at submit (direct engine
    callers get the same contract). Idempotent: both call sites write
    the same values. None span = untraced request, no-op."""
    if span is None:
        return
    span.set("tenant", str(tenant))
    span.set("prompt_tokens", int(prompt_tokens))
    span.set("max_new_tokens", int(max_new_tokens))
    if deadline_s is not None:
        span.set("deadline_ms", round(float(deadline_s) * 1000.0, 3))


# There is deliberately NO process-default recorder: each plane's entry
# point (BundleServer, RouterServer, PipelineCoordinator) owns its own
# TraceRecorder, and everything downstream reaches the live trace only
# through an explicit span (request-attached in the engine) or the
# contextvar (``current_span`` — what ``utils/profiling.annotate`` and
# the log-record filter read). A hidden global would let two planes in
# one process silently share a ring.
