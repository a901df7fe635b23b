"""HTTP (and stdin) serving of an exported bundle on the card (the
counterpart of ``pyspark_tf_gke_tpu/train/serve.py``).

``python -m pyspark_tf_gke_tpu_torch.train.serve --bundle DIR
--continuous-slots 8`` loads a bundle onto ``--device`` (``cuda`` by
default) and answers

* ``GET  /healthz``      -> 200 with the bundle and engine status (503
  while draining);
* ``GET  /livez``        -> liveness: 503 only when the engine's driver
  loop has stalled past ``--live-stall``; reports a step-watchdog wedge;
* ``GET  /loadz``        -> the load snapshot a router's prober reads
  (the JAX server's key set);
* ``GET  /stepz``        -> the engine-step records (``?n=``,
  ``?min_ms=``) and their summary;
* ``GET  /metrics``, ``/metrics.json`` -> the Prometheus exposition of
  the ``train_`` / ``serve_`` / ``runtime_`` families (the JAX server's
  names, plus its ``pyspark_tf_gke_tpu_serve_*`` aliases) and its JSON
  snapshot with trace-id exemplars;
* ``GET  /events``       -> the event trail's tail (``?n=``);
* ``GET  /traces``       -> the request-trace flight recorder
  (``?slow_ms=``, ``?trace_id=``, ``?n=``, ``?format=jsonl``);
* ``POST /v1/generate``  -> ``{"completions": [{"prompt", "completion",
  "new_tokens", "latency_ms"}, ...]}`` for ``{"prompts": [...]}`` (or
  ``"prompt"``), ``max_new_tokens``, ``temperature``, ``top_k``,
  ``top_p``, ``repetition_penalty``, ``num_beams`` (beam search: each
  entry gains ``beam_score``), ``seed``, ``deadline_ms`` (504 once past)
  and ``tenant`` (or the ``X-Tenant`` header); with ``"stream": true``
  server-sent events (a ``: trace_id=`` comment, ``data: {json}`` a
  token group, the terminal entry and ``data: [DONE]``), and with
  ``"continuation": {"emitted_ids": [...]}`` the continuation of a
  stream another replica started (the router's failover splice);
* ``POST /v1/score``     -> ``{"scores": [{"nll", "tokens",
  "truncated"}, ...]}`` for ``{"texts": [...]}``;
* ``POST /v1/warm``, ``/v1/prefill``, ``/v1/kv_import`` -> a prefix into
  the prefix cache; a prompt's KV pages as a blob; a blob into the
  pool (the disaggregated handoff, across packages too; a dense engine
  has no pages and refuses both, as the JAX server does);
* ``POST /admin/reload`` -> hot swap to ``{"bundle": DIR, "generation":
  N}``: load and verify, drain the old engine (``drain_s``), a canary
  generate on the new weights, rollback on failure (502), 409 while one
  is in flight; ``POST /admin/profile`` -> a ``torch.profiler`` capture
  of the next ``steps`` busy engine steps written as a Chrome trace into
  ``output_dir`` (202; ``profile_trace_written`` on ``/events``). Both
  need ``SERVE_ADMIN_TOKEN`` (403 without one, 401 on a wrong
  ``X-Admin-Token``).

Every response echoes ``X-Request-Id``, the trace id of the request's
span (the caller's ``traceparent`` adopted, else a new root); the engine
annotates the span's queue wait, admission, prefill, first token and
terminal (``--trace-sample``, ``--trace-slow-ms``). ``--step-timeout``
arms the step watchdog (every waiter of a hung step gets an
``EngineWedged`` terminal; the engine rebuilds when the step returns),
``--heartbeat-file`` is beaten by the driver loop, ``--chaos`` injects
faults (``fail@N`` / ``slow@N:S`` in the driver loop, and the named
points ``serve.request``, ``engine.admit``, ``engine.device_step``,
``bundle.load``), ``--metrics-textfile`` writes the exposition for a
node exporter, ``--stdin`` serves stdin lines.

Routing follows the JAX server: with ``--continuous-slots`` greedy and
temperature/top-p requests share the slot engine's KV slots; beams,
top-k and repetition-penalty requests run the whole-batch path. The
engine runs decode-ahead by default (``--continuous-pipeline 1``), on
CUDA its decode chunks replay captured CUDA graphs;
``--adaptive-chunk`` sizes chunks to the remaining budgets and
``--prefix-cache N`` keeps up to N pages of completed prompts in the
radix prefix cache of a paged bundle, or N warmed prefixes in the LRU
of a dense one (a bundle without ``kv_num_pages`` runs the dense slot
cache). ``--spec-tokens k`` makes the engine speculate in
its slots, drafting with ``--draft-bundle`` (or, without one, the
target itself); ``--draft-bundle`` alone serves a single greedy prompt
through the standalone speculative driver. Admission is bounded
(``--max-queue-depth``, ``--max-queued-tokens``: 429 with
``Retry-After``), ``--tenants`` shares it between tenants (DWRR weights,
queue shares and token buckets; a tenant's shed carries
``X-Tenant-Shed``), ``--schedule longest`` admits the longest budget
first, ``--role`` is what ``/loadz`` advertises to a disaggregating
router, and SIGTERM drains (new requests 503, in-flight ones finish,
``--drain-timeout``) before the server stops. Not ported (ROADMAP queue
1, P11b): the multi-host serve wire: ``--tp`` over 1 and
``--num-processes`` over 1 raise ``NotImplementedError`` (the JAX
server's ``--process-id`` and coordinator flags are taken and unused
with one process).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import gc
import hmac
import itertools
import json
import os
import queue
import signal
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.chaos.inject import (chaos_fire,
                                                  install as chaos_install,
                                                  split_serve_chaos_spec)
from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer
from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
from pyspark_tf_gke_tpu_torch.models.causal_lm import generate
from pyspark_tf_gke_tpu_torch.models.speculative import speculative_generate
from pyspark_tf_gke_tpu_torch.obs.events import get_event_log
from pyspark_tf_gke_tpu_torch.obs.export import (PROMETHEUS_CONTENT_TYPE,
                                                 TextfileExporter,
                                                 handle_obs_request)
from pyspark_tf_gke_tpu_torch.obs.metrics import (get_registry,
                                                  platform_families)
from pyspark_tf_gke_tpu_torch.obs.runtime import install_runtime_metrics
from pyspark_tf_gke_tpu_torch.obs.stepstats import StepStatsRing
from pyspark_tf_gke_tpu_torch.obs.trace import (TraceRecorder,
                                                annotate_request_shape,
                                                use_span)
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle
from pyspark_tf_gke_tpu_torch.train.kv_transfer import (pack_kv_export,
                                                        unpack_kv_blob)
from pyspark_tf_gke_tpu_torch.train.resilience import (Heartbeat,
                                                       retry_with_backoff)
from pyspark_tf_gke_tpu_torch.train.serving import serve_score
from pyspark_tf_gke_tpu_torch.utils.fs import fs_copy_tree, is_remote
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("torch.train.serve")

MAX_BODY_BYTES = 8 << 20
MAX_BATCH = 64
SPEC_GAMMA = 4  # the standalone speculative path's draft width (echoed)
# a bundle load's deterministic errors fail at once instead of retrying
_PERMANENT_LOAD_ERRORS = (FileNotFoundError, ValueError, KeyError,
                          TypeError)


class RequestRejected(RuntimeError):
    """A shed before any device work: HTTP 429 (``queue_full``,
    ``tenant_quota``, ``tenant_queue_full``) or 503 (``draining``) with a
    ``Retry-After``. ``tenant`` is set on a per-tenant shed, which the
    handler surfaces as ``X-Tenant-Shed`` (a verdict about one tenant,
    not about the replica's health)."""

    def __init__(self, reason: str, message: str, status: int,
                 retry_after_s: int = 1, tenant: Optional[str] = None):
        super().__init__(message)
        self.reason = reason
        self.status = int(status)
        self.retry_after_s = int(retry_after_s)
        self.tenant = tenant


def _draining_rejection() -> RequestRejected:
    """The one draining rejection (admission gate, whole-batch path and
    handler alike)."""
    return RequestRejected(
        "draining",
        "server is draining (shutting down); retry against a live "
        "replica", status=503, retry_after_s=5)


def _reloading_rejection() -> RequestRejected:
    """The terminal of a request a hot swap could not drain within its
    grace window: explicit and retryable (the new bundle serves the
    retry)."""
    return RequestRejected(
        "reloading",
        "bundle hot-swap interrupted this request; retry", status=503,
        retry_after_s=1)


class ReloadInFlight(RuntimeError):
    """A bundle reload is already running (HTTP 409)."""


class ProfileInFlight(RuntimeError):
    """A profiler capture is already armed or running (HTTP 409):
    ``torch.profiler`` holds one session a process."""


class BundleReloadError(RuntimeError):
    """A reload failed (HTTP 502). ``rolled_back``: the new bundle got as
    far as serving before its canary failed and the previous one was
    reinstalled (True), or it never installed (False). Either way the
    advertised ``bundle_generation`` did not advance."""

    def __init__(self, message: str, rolled_back: bool):
        super().__init__(message)
        self.rolled_back = bool(rolled_back)


class TokenBucket:
    """One tenant's token-rate quota: ``rate`` tokens/s refill up to
    ``burst``. Admission charges the worst case (prompt + budget) with
    :meth:`try_take`; delivery refunds the unused budget, so a quota
    shed only ever happens at admission. Thread-safe."""

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0:
            raise ValueError(f"rate must be > 0, got {rate_per_s}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._level = float(burst)  # a fresh server admits at once
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._level = min(self.burst,
                          self._level + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float) -> bool:
        with self._lock:
            self._refill(time.monotonic())
            if self._level >= n:
                self._level -= n
                return True
            return False

    def refund(self, n: float) -> None:
        """Return an unused charge (never past ``burst``)."""
        if n <= 0:
            return
        with self._lock:
            self._refill(time.monotonic())
            self._level = min(self.burst, self._level + float(n))

    def retry_after_s(self, n: float) -> int:
        """Whole seconds until ``n`` tokens refill (at least 1): a quota
        shed's ``Retry-After``."""
        with self._lock:
            self._refill(time.monotonic())
            if self._level >= n:
                return 1
            need = min(float(n), self.burst) - self._level
        return max(1, int(-(-need // self.rate)))

    @property
    def level(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._level


def parse_tenant_spec(spec) -> Optional[Dict[str, dict]]:
    """The ``--tenants`` spec as ``{tenant: {"weight", "rate", "burst"}}``.

    Either a JSON object (``{"light": {"weight": 3}, "noisy": {"weight":
    1, "rate": 200, "burst": 400}}``, or ``{"light": 3}``) or the compact
    ``name=weight[:rate[:burst]],...``. ``weight`` is the tenant's DWRR
    share and its slice of the queue bounds; ``rate`` (tokens/s, absent
    = unmetered) and ``burst`` (2 x rate by default) its token bucket; a
    ``*`` entry covers tenants the spec does not name. Empty -> None
    (tenancy off)."""
    if not spec:
        return None
    if isinstance(spec, dict):
        raw = spec
    else:
        spec = str(spec).strip()
        if spec.startswith("{"):
            raw = json.loads(spec)
            if not isinstance(raw, dict):
                raise ValueError(f"tenant spec must be a JSON object, "
                                 f"got {type(raw).__name__}")
        else:
            raw = {}
            for part in spec.split(","):
                part = part.strip()
                if not part:
                    continue
                name, _, rest = part.partition("=")
                if not name or not rest:
                    raise ValueError(
                        f"bad tenant spec entry {part!r} (want "
                        "name=weight[:rate[:burst]])")
                fields = rest.split(":")
                entry: dict = {"weight": float(fields[0])}
                if len(fields) > 1 and fields[1]:
                    entry["rate"] = float(fields[1])
                if len(fields) > 2 and fields[2]:
                    entry["burst"] = float(fields[2])
                if len(fields) > 3:
                    raise ValueError(
                        f"bad tenant spec entry {part!r}: too many "
                        "fields")
                raw[name.strip()] = entry
    out: Dict[str, dict] = {}
    for name, entry in raw.items():
        if not isinstance(entry, dict):
            entry = {"weight": entry}
        weight = float(entry.get("weight", 1.0))
        if weight <= 0:
            raise ValueError(
                f"tenant {name!r} weight must be > 0, got {weight}")
        rate = entry.get("rate")
        rate = float(rate) if rate is not None else None
        if rate is not None and rate <= 0:
            raise ValueError(
                f"tenant {name!r} rate must be > 0, got {rate}")
        burst = entry.get("burst")
        burst = (float(burst) if burst is not None
                 else (2.0 * rate if rate is not None else None))
        unknown = set(entry) - {"weight", "rate", "burst"}
        if unknown:
            raise ValueError(
                f"tenant {name!r}: unknown field(s) {sorted(unknown)}")
        out[str(name)] = {"weight": weight, "rate": rate, "burst": burst}
    return out or None


class DeadlineExceeded(RuntimeError):
    """The client's deadline passed (HTTP 504): the request expired in
    the queue or was cancelled in its slot at a chunk boundary."""


class EngineShutdown(RuntimeError):
    """Delivered to every pending waiter when the front shuts down."""


class EngineWedged(RuntimeError):
    """The step watchdog's terminal for every waiter of an engine step
    that ran past ``--step-timeout``: the client hears now, and the
    engine rebuilds when the stuck step returns."""


class _ContinuousFront:
    """One engine thread runs the slot engine; HTTP threads ``submit``
    (or ``submit_stream``) and ``wait``. The front gates admission
    (drain, queue depth and tokens, per-tenant shares and token
    buckets) before the engine sees a request, and settles every
    delivery (a refund of the unused budget, exactly one terminal per
    waiter). A step that raises fails every outstanding request with
    the error and the engine is rebuilt (its device state may be
    mid-chunk garbage); warmed prefixes are warmed again.

    A watchdog thread reaps the waiters of a step that runs past
    ``step_timeout_s`` (:class:`EngineWedged`, touching only the results
    lock: the driver holds the engine lock for the whole stuck step) and
    the engine rebuilds when that step returns. The driver loop beats
    ``heartbeat``, runs ``chaos`` (a :class:`FaultInjector`) on busy
    iterations, and drives an armed ``torch.profiler`` capture.

    ``engine_kw`` go to ``ContinuousEngine``; ``tenants`` is a
    :func:`parse_tenant_spec` spec. The step-stats ring outlives engine
    rebuilds."""

    def __init__(self, model, tenants=None, max_queue_depth: int = 0,
                 max_queued_tokens: int = 0,
                 stepstats: Optional[StepStatsRing] = None, obs=None,
                 event_log=None, chaos=None, heartbeat=None,
                 step_timeout_s: float = 0.0, tracer=None, **engine_kw):
        # tenancy off (no spec): every request rides "default" and the
        # admission bounds stay global
        self._tenants = parse_tenant_spec(tenants)
        self._tenant_weights = ({name: c["weight"]
                                 for name, c in self._tenants.items()}
                                if self._tenants else None)
        self._buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(c["rate"], c["burst"])
            for name, c in (self._tenants or {}).items()
            if c["rate"] is not None}
        self.stepstats = stepstats if stepstats is not None else (
            StepStatsRing())
        self._obs = obs if obs is not None else platform_families()
        self._event_log = (event_log if event_log is not None
                           else get_event_log())
        self._model, self._engine_kw = model, engine_kw
        # 0 = unbounded; past a bound submit sheds with RequestRejected
        self.max_queue_depth = int(max_queue_depth)
        self.max_queued_tokens = int(max_queued_tokens)
        # the driver loop's busy iterations drive --chaos fail@N/slow@N:S
        self._chaos = chaos
        self._chaos_step = 0
        self._heartbeat = heartbeat
        self.draining = threading.Event()
        self.engine: ContinuousEngine = self._new_engine()
        self.lock = threading.Lock()  # guards the engine
        # HTTP threads waiting for (or holding) the lock: the driver loop
        # lets them in between two steps, where it would otherwise take
        # the lock straight back (a busy loop starves them)
        self._waiting = 0
        self._waiting_cv = threading.Condition()
        self.new_work = threading.Event()
        self.stop = threading.Event()
        # rid -> [done event, tokens | Exception | None, stream queue |
        # None]; the dict has its own lock, always inner to self.lock,
        # so the watchdog reaps while a stuck step holds self.lock
        self._results: Dict[int, list] = {}
        self._results_lock = threading.Lock()
        self._warmed: List[List[int]] = []  # re-warmed after a rebuild
        # the step watchdog: 0 = off (a live attribute, retunable)
        self.step_timeout_s = float(step_timeout_s)
        self._step_started: Optional[float] = None
        self._wedged = False
        # the driver loop's last iteration: /livez reads it
        self._last_loop_ts = time.monotonic()
        # an armed or running torch.profiler capture (POST /admin/profile)
        self._profile_lock = threading.Lock()
        self._profile: Optional[dict] = None
        self._tracer = tracer
        self.thread = threading.Thread(target=self._loop,
                                       name="continuous-engine", daemon=True)
        self.thread.start()
        # always running (an idle 1 Hz sweep while the timeout is 0), so
        # a timeout armed at run time takes effect
        self._watchdog = threading.Thread(target=self._watch_steps,
                                          name="step-watchdog", daemon=True)
        self._watchdog.start()

    @contextlib.contextmanager
    def _locked(self, timeout_s: float = -1):
        """The engine lock, taken by an HTTP thread: yields whether it
        was acquired (within ``timeout_s``; -1 waits)."""
        with self._waiting_cv:
            self._waiting += 1
        acquired = self.lock.acquire(timeout=timeout_s)
        try:
            yield acquired
        finally:
            if acquired:
                self.lock.release()
            with self._waiting_cv:
                self._waiting -= 1
                self._waiting_cv.notify_all()

    def _new_engine(self) -> ContinuousEngine:
        return ContinuousEngine(self._model,
                                tenant_weights=self._tenant_weights,
                                stepstats=self.stepstats, obs=self._obs,
                                **self._engine_kw)

    # -- tenancy ---------------------------------------------------------
    def resolve_tenant(self, tenant: Optional[str]) -> str:
        """A client's tenant id as the fairness machinery sees it:
        without a spec always "default"; with one, a named tenant passes
        and every other id folds into the one ``*`` aggregate (made-up
        ids gain no share and mint no state)."""
        if self._tenants is None:
            return "default"
        t = str(tenant) if tenant else "default"
        return t if (t in self._tenants and t != "*") else "*"

    def _tenant_share(self, tenant: str, bound: int) -> int:
        """A resolved tenant's weight-proportional slice of a global
        bound. The denominator sums the spec's weights; without a ``*``
        entry the unnamed aggregate weighs 1.0 in its own denominator
        only."""
        cfgs = self._tenants
        total = sum(c["weight"] for c in cfgs.values())
        if tenant == "*" and "*" not in cfgs:
            w = 1.0
            total += w
        else:
            w = cfgs[tenant]["weight"]
        return max(1, int(bound * w / max(total, w)))

    def _bucket_for(self, tenant: str) -> Optional[TokenBucket]:
        if not self._tenants:
            return None
        return self._buckets.get(tenant)

    def _shed_tenant(self, tenant: str, reason: str, message: str,
                     retry_after_s: int) -> None:
        self._obs["serve_requests_rejected_total"].labels(
            reason=reason).inc()
        self._obs["serve_tenant_rejected_total"].labels(
            tenant=tenant, reason=reason).inc()
        raise RequestRejected(reason, message, status=429,
                              retry_after_s=retry_after_s, tenant=tenant)

    def charge_tokens(self, tenant: Optional[str], n: int) -> str:
        """Charge ``n`` tokens of work outside the engine (``/v1/score``)
        to the tenant's bucket, up front and without refund; the same
        429 / terminal 400 as admission. Returns the resolved tenant."""
        tenant = self.resolve_tenant(tenant)
        bucket = self._bucket_for(tenant)
        if bucket is None:
            return tenant
        if n > bucket.burst:
            raise ValueError(
                f"score batch of {n} tokens exceeds tenant {tenant!r} "
                f"quota burst {bucket.burst:g} — split the batch")
        if not bucket.try_take(n):
            self._shed_tenant(
                tenant, "tenant_quota",
                f"tenant {tenant!r} token quota exhausted (score "
                f"batch needs {n} tokens; refill {bucket.rate:g}/s)",
                retry_after_s=bucket.retry_after_s(n))
        return tenant

    def _settle(self, req) -> None:
        """Refund a delivered (or expired, or failed) request's unused
        budget to its tenant's bucket and count its tokens."""
        bucket = self._buckets.get(req.tenant)
        if bucket is not None:
            unused = int(req.max_new_tokens) - len(req.tokens)
            if unused > 0:
                bucket.refund(unused)
        if req.tokens:
            self._obs["serve_tenant_tokens_total"].labels(
                tenant=req.tenant).inc(len(req.tokens))

    def _check_admission(self, prompt_len: int, max_new_tokens: int,
                         tenant: str = "default") -> None:
        """The admission gates, in the JAX front's order (caller holds
        ``self.lock``): draining (503), an ask that can never fit (400),
        then the global bounds (429 ``queue_full``) or, with a tenant
        spec, the tenant's queue share and token bucket (429 with the
        tenant and its own ``Retry-After``)."""
        if self.draining.is_set():
            self._obs["serve_requests_rejected_total"].labels(
                reason="draining").inc()
            raise _draining_rejection()
        ask = int(prompt_len) + int(max_new_tokens)
        if self.max_queued_tokens and ask > self.max_queued_tokens:
            raise ValueError(
                f"request footprint {ask} tokens (prompt + budget) "
                f"exceeds max_queued_tokens {self.max_queued_tokens}")
        if self._tenants is None:
            if self.max_queue_depth:
                depth = self.engine.queue_depth()
                if depth >= self.max_queue_depth:
                    self._obs["serve_requests_rejected_total"].labels(
                        reason="queue_full").inc()
                    raise RequestRejected(
                        "queue_full",
                        f"admission queue full ({depth} waiting >= "
                        f"max_queue_depth {self.max_queue_depth})",
                        status=429, retry_after_s=1)
            if self.max_queued_tokens:
                queued = self.engine.queued_tokens()
                if queued + ask > self.max_queued_tokens:
                    self._obs["serve_requests_rejected_total"].labels(
                        reason="queue_full").inc()
                    raise RequestRejected(
                        "queue_full",
                        f"queued-token budget exhausted ({queued} queued "
                        f"+ {ask} requested > max_queued_tokens "
                        f"{self.max_queued_tokens})",
                        status=429, retry_after_s=1)
            return
        if self.max_queue_depth:
            share = self._tenant_share(tenant, self.max_queue_depth)
            depth = self.engine.queue_depth(tenant)
            if depth >= share:
                self._shed_tenant(
                    tenant, "tenant_queue_full",
                    f"tenant {tenant!r} admission-queue share full "
                    f"({depth} waiting >= share {share} of "
                    f"max_queue_depth {self.max_queue_depth})",
                    retry_after_s=1)
        if self.max_queued_tokens:
            share = self._tenant_share(tenant, self.max_queued_tokens)
            if ask > share:
                raise ValueError(
                    f"request footprint {ask} tokens exceeds tenant "
                    f"{tenant!r} queued-token share {share}")
            queued = self.engine.queued_tokens(tenant)
            if queued + ask > share:
                self._shed_tenant(
                    tenant, "tenant_queue_full",
                    f"tenant {tenant!r} queued-token share exhausted "
                    f"({queued} queued + {ask} requested > share "
                    f"{share} of max_queued_tokens "
                    f"{self.max_queued_tokens})",
                    retry_after_s=1)
        bucket = self._bucket_for(tenant)
        if bucket is not None:
            if ask > bucket.burst:
                raise ValueError(
                    f"request footprint {ask} tokens exceeds tenant "
                    f"{tenant!r} quota burst {bucket.burst:g} — it can "
                    "never admit at any retry")
            if not bucket.try_take(ask):
                self._shed_tenant(
                    tenant, "tenant_quota",
                    f"tenant {tenant!r} token quota exhausted "
                    f"(request needs {ask} tokens; refill "
                    f"{bucket.rate:g}/s)",
                    retry_after_s=bucket.retry_after_s(ask))

    # -- submission and delivery -----------------------------------------
    def _submit(self, prompt_ids, max_new_tokens: int, tenant, stream,
                span=None, deadline_s=None, **kw):
        tenant = self.resolve_tenant(tenant)
        # the shape before the gates: a shed request is demand a replay
        # of this trace must still see
        annotate_request_shape(span, tenant=tenant,
                               prompt_tokens=len(prompt_ids),
                               max_new_tokens=max_new_tokens,
                               deadline_s=deadline_s)
        q = queue.Queue() if stream else None
        with self._locked():
            self._check_admission(len(prompt_ids), max_new_tokens,
                                  tenant=tenant)
            try:
                rid = self.engine.submit(
                    prompt_ids, max_new_tokens, tenant=tenant,
                    on_tokens=q.put if stream else None,
                    deadline_s=deadline_s, span=span, **kw)
            except BaseException:
                # the quota charge landed in _check_admission: a request
                # that never queued must not cost its tenant
                bucket = self._buckets.get(tenant)
                if bucket is not None:
                    bucket.refund(len(prompt_ids) + int(max_new_tokens))
                raise
            with self._results_lock:
                self._results[rid] = [threading.Event(), None, q]
        self._obs["serve_tenant_requests_total"].labels(tenant=tenant).inc()
        self.new_work.set()
        return rid, q

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, top_p=None, seed: int = 0,
               deadline_s=None, tenant: str = "default", span=None) -> int:
        """Queue a request (non-blocking); pair with :meth:`wait`.
        ``deadline_s`` expires it at a chunk boundary (``wait`` raises
        :class:`DeadlineExceeded`); ``tenant`` is resolved here; ``span``
        is the request's trace span."""
        return self._submit(prompt_ids, max_new_tokens, tenant, False,
                            span=span, deadline_s=deadline_s,
                            temperature=temperature, top_p=top_p,
                            seed=seed)[0]

    def submit_stream(self, prompt_ids, max_new_tokens: int,
                      deadline_s=None, tenant: str = "default", span=None):
        """Greedy streaming variant: ``(rid, queue)``. The queue gets each
        collected token group, then one terminal: ``[]`` on completion or
        an exception (failure, deadline, shutdown). The charge covers the
        whole budget, so a stream is never quota-cut mid-flight."""
        return self._submit(prompt_ids, max_new_tokens, tenant, True,
                            span=span, deadline_s=deadline_s)

    def submit_internal(self, prompt_ids, max_new_tokens: int) -> int:
        """An engine submit past the admission gates, for the server's
        own probes (the reload canary): a canary shed by overload would
        roll back a good bundle when the fleet is busiest. Its reserved
        tenant is in no client's bucket."""
        with self._locked():
            rid = self.engine.submit(prompt_ids, max_new_tokens,
                                     tenant="__internal__")
            with self._results_lock:
                self._results[rid] = [threading.Event(), None, None]
        self.new_work.set()
        return rid

    def wait(self, rid: int, timeout_s: float = 600.0) -> List[int]:
        with self._results_lock:
            entry = self._results.get(rid)
        if entry is None:
            raise KeyError(f"unknown or already-collected request {rid}")
        if not entry[0].wait(timeout_s):
            with self._locked():
                # an abandoned request must not keep its slot
                self.engine.cancel(rid)
                with self._results_lock:
                    self._results.pop(rid, None)
            raise RuntimeError(
                f"continuous decode timed out after {timeout_s}s")
        with self._results_lock:
            # the watchdog leaves reaped entries here for this pop
            self._results.pop(rid, None)
        result = entry[1]
        if isinstance(result, (DeadlineExceeded, EngineShutdown,
                               RequestRejected)):
            raise result
        if isinstance(result, Exception):
            raise RuntimeError(
                f"continuous engine failed this request: {result}")
        return result

    def abandon(self, rid: int) -> None:
        """Give up on a request: free its slot or queue place and drop
        its results entry (idempotent). The lock is taken with a bound:
        if a step holds it that long (a wedge), the rebuild clears the
        engine, and a merely busy engine runs the request out."""
        with self._locked(timeout_s=1.0) as acquired:
            if acquired:
                self.engine.cancel(rid)
        with self._results_lock:
            self._results.pop(rid, None)

    def warm_prefix(self, prefix_ids) -> int:
        """Prefill and cache a prefix (under the engine lock); kept so a
        rebuilt engine warms it again."""
        with self._locked():
            n = self.engine.warm_prefix(prefix_ids)
            toks = [int(t) for t in prefix_ids]
            if toks not in self._warmed:
                self._warmed.append(toks)
                del self._warmed[:-self.engine.warm_capacity]
            return n

    def export_prefix_pages(self, prefix_ids):
        """The prefill side of a KV handoff (under the engine lock)."""
        with self._locked():
            return self.engine.export_prefix_pages(prefix_ids)

    def import_prefix_pages(self, token_ids, layers) -> int:
        """The decode side of a KV handoff (under the engine lock)."""
        with self._locked():
            return self.engine.import_prefix_pages(token_ids, layers)

    def _fail_pending(self, err: Exception, reason: Optional[str] = None
                      ) -> int:
        """Exactly one terminal, ``err``, to every waiter still without
        one (claimed under the results lock, so a racing delivery or
        watchdog sweep never doubles it); ``reason`` counts each in
        ``serve_requests_rejected_total``. Returns how many."""
        n = 0
        with self._results_lock:
            for slot in self._results.values():
                if slot[1] is None and not slot[0].is_set():
                    slot[1] = err
                    slot[0].set()
                    if slot[2] is not None:
                        slot[2].put(err)
                    n += 1
        if reason is not None and n:
            self._obs["serve_requests_rejected_total"].labels(
                reason=reason).inc(n)
        return n

    def _deliver_finished(self, finished) -> None:
        """Settle one step's finished and expired requests (refunds),
        then give each waiter its one terminal: the tokens, or
        :class:`DeadlineExceeded`; a stream also gets ``[]`` or the
        error on its queue. A waiter the watchdog already answered is
        skipped. Caller holds ``self.lock``."""
        if not finished:
            return
        for req in finished:
            self._settle(req)
        with self._results_lock:
            for req in finished:
                slot = self._results.get(req.rid)
                if slot is None or slot[1] is not None or slot[0].is_set():
                    continue
                if req.expired:
                    slot[1] = DeadlineExceeded(
                        f"request deadline exceeded after "
                        f"{len(req.tokens)} decoded token(s)")
                else:
                    slot[1] = req.tokens
                slot[0].set()
                if slot[2] is not None:
                    slot[2].put(slot[1] if req.expired else [])

    def _rebuild(self) -> None:
        """A fresh engine in place of the current one (its device state
        is untrustworthy after a failed or hung step), warmed prefixes
        warmed again. Caller holds ``self.lock``."""
        self.engine = None
        gc.collect()  # the old engine's graphs and pool go now
        self.engine = self._new_engine()
        for toks in self._warmed:
            try:
                self.engine.warm_prefix(toks)
            except Exception:  # noqa: BLE001
                logger.exception("re-warm of a cached prefix failed "
                                 "after a rebuild")

    def swap_model(self, model, eos_id, pad_id, drain_s: float = 30.0):
        """Hot swap: the old engine is stepped to completion here, under
        the lock, so in-flight requests and streams finish on the weights
        they started on, bounded by ``drain_s``; the pipeline is
        quiesced; anything still unfinished gets a retryable 503
        ``reloading`` terminal. Then a new engine starts on ``model``
        (its graphs captured on its first busy step) and the warmed
        prefixes are dropped (they were prefilled under the old
        bundle). The old engine is released before the new one is
        built, so the card holds one engine's pool and graphs."""
        with self._locked():
            deadline = time.monotonic() + float(drain_s)
            try:
                while time.monotonic() < deadline and self.engine.busy:
                    self._deliver_finished(self.engine.step())
                self._deliver_finished(self.engine.quiesce())
            except Exception:  # noqa: BLE001 — the sweep below answers
                logger.exception(
                    "old engine failed while draining for a bundle swap")
            try:
                for req in self.engine.fail_outstanding("shed"):
                    self._settle(req)
            except Exception:  # noqa: BLE001 — refunds must not block
                logger.exception("settling the old engine's requests "
                                 "failed")
            self._fail_pending(_reloading_rejection(), reason="reloading")
            self._model = model
            self._engine_kw["eos_token_id"] = eos_id
            self._engine_kw["pad_id"] = pad_id
            self._warmed.clear()
            self._rebuild()

    # -- the step watchdog -----------------------------------------------
    def _watch_steps(self) -> None:
        """Reap the waiters of a hung step. Touches only
        ``_results_lock`` (the driver holds ``self.lock`` for the whole
        stuck step)."""
        while not self.stop.is_set():
            timeout = self.step_timeout_s
            started = self._step_started
            if (timeout > 0 and started is not None
                    and time.monotonic() - started > timeout):
                self._reap_wedged(time.monotonic() - started)
            self.stop.wait(max(0.05, min(1.0, timeout / 4))
                           if timeout > 0 else 1.0)

    def _reap_wedged(self, stuck_s: float) -> None:
        """One watchdog sweep over a stuck step: flag the wedge (the
        driver rebuilds when the step returns; ``/livez`` reports it)
        and give every waiter without a terminal an
        :class:`EngineWedged` one. Entries stay for ``wait`` to pop.
        Re-runs each poll while the step stays stuck."""
        first = not self._wedged
        self._wedged = True
        reaped = self._fail_pending(EngineWedged(
            f"engine step exceeded step_timeout {self.step_timeout_s:g}s "
            f"(stuck {stuck_s:.1f}s); the step watchdog failed this "
            "request"))
        if first or reaped:
            self._obs["serve_step_watchdog_reaps_total"].inc()
            self._event_log.emit("engine_watchdog_reap", reaped=reaped,
                                 stuck_s=round(stuck_s, 3),
                                 step_timeout_s=self.step_timeout_s)
            logger.error(
                "step watchdog: engine step stuck %.1fs (> %gs); failed "
                "%d in-flight request(s); the engine rebuilds when the "
                "step returns", stuck_s, self.step_timeout_s, reaped)

    # -- the profiler capture --------------------------------------------
    def start_profile(self, output_dir: str, steps: int) -> dict:
        """Arm a ``torch.profiler`` capture: the driver loop starts it
        at the next busy step and stops it after ``steps`` closed step
        records (:class:`ProfileInFlight` while one is armed)."""
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"profile steps must be >= 1, got {steps}")
        with self._profile_lock:
            if self._profile is not None:
                raise ProfileInFlight(
                    "a profiler capture is already in flight")
            self._profile = {"dir": str(output_dir), "steps": steps,
                             "remaining": steps, "prof": None,
                             "seq_first": None, "seq_last": None}
        return {"output_dir": str(output_dir), "steps": steps,
                "armed": True}

    def profile_in_flight(self) -> bool:
        with self._profile_lock:
            return self._profile is not None

    def _profile_maybe_start(self) -> None:
        """Driver hook before a busy step: start the armed capture."""
        p = self._profile
        if p is None or p["prof"] is not None:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            p["prof"] = prof
            logger.info("profiler capture started -> %s (%d steps)",
                        p["dir"], p["steps"])
        except Exception:  # noqa: BLE001 — a profiler that will not
            # start (another session open) disarms, never kills the loop
            logger.exception("torch.profiler did not start; capture "
                             "disarmed")
            with self._profile_lock:
                self._profile = None

    def _profile_note_step(self, seq: int) -> None:
        """Driver hook after a step that closed record ``seq``: count it
        and, at the last, stop the capture, write the Chrome trace and
        emit ``profile_trace_written`` with the step-seq window and the
        recorder's recent trace ids."""
        p = self._profile
        if p is None or p["prof"] is None:
            return
        if p["seq_first"] is None:
            p["seq_first"] = seq
        p["seq_last"] = seq
        p["remaining"] -= 1
        if p["remaining"] > 0:
            return
        path = os.path.join(
            p["dir"], f"trace_steps_{p['seq_first']}-{p['seq_last']}.json")
        try:
            p["prof"].stop()
            p["prof"].export_chrome_trace(path)
        except Exception:  # noqa: BLE001
            logger.exception("writing the profiler capture failed")
            path = None
        trace_ids = []
        if self._tracer is not None:
            trace_ids = [t.get("trace_id")
                         for t in self._tracer.traces(limit=8)]
        self._event_log.emit(
            "profile_trace_written", output_dir=p["dir"], trace_file=path,
            steps=p["steps"], step_seq_first=p["seq_first"],
            step_seq_last=p["seq_last"], trace_ids=trace_ids)
        logger.info("profiler capture written to %s (steps %s..%s)",
                    path, p["seq_first"], p["seq_last"])
        with self._profile_lock:
            self._profile = None

    def _stop_profile(self) -> None:
        """Close a running capture without writing it (shutdown)."""
        with self._profile_lock:
            p, self._profile = self._profile, None
        if p is not None and p["prof"] is not None:
            with contextlib.suppress(Exception):
                p["prof"].stop()

    # -- the driver loop -------------------------------------------------
    def _loop(self) -> None:
        beat = 0
        while not self.stop.is_set():
            beat += 1
            self._last_loop_ts = time.monotonic()
            if self._heartbeat is not None:
                try:
                    self._heartbeat.beat(beat)
                except OSError:  # liveness never takes the loop down
                    pass
            busy = False
            seq0 = None
            with self._waiting_cv:  # HTTP threads first, briefly
                self._waiting_cv.wait_for(lambda: not self._waiting,
                                          timeout=0.01)
            with self.lock:
                try:
                    busy = self.engine.busy
                    if busy and self._chaos is not None:
                        # counted on busy iterations only; a raise lands
                        # in the rebuild below, as a failed step does
                        self._chaos_step += 1
                        self._chaos.maybe_slow(self._chaos_step)
                        self._chaos.maybe_fail(self._chaos_step)
                    if busy:
                        self._profile_maybe_start()
                        seq0 = self.stepstats.next_seq
                        self._step_started = time.monotonic()
                    try:
                        finished = self.engine.step() if busy else []
                    finally:
                        self._step_started = None
                    t_deliver = time.monotonic()
                    self._deliver_finished(finished)
                    if busy:
                        # the chunk in flight often retires during the
                        # delivery: keep that out of its busy interval,
                        # and amend the delivery onto the step's record
                        self.engine.poll_retire()
                        rec = self.stepstats.last_record
                        if (rec is not None and rec.closed
                                and rec.seq >= seq0):
                            self.stepstats.add_deliver(
                                rec, (time.monotonic() - t_deliver) * 1e3)
                            if self._wedged:
                                self.stepstats.mark_reaped(rec)
                            self._profile_note_step(rec.seq)
                    if self._wedged:
                        # the stuck step returned: its waiters were
                        # reaped; rebuild through the failed-step path
                        self._wedged = False
                        raise RuntimeError(
                            "engine step exceeded the watchdog timeout; "
                            "rebuilding")
                except Exception as exc:  # noqa: BLE001 — keep serving
                    logger.exception("engine step failed; failing %d "
                                     "request(s) and rebuilding",
                                     len(self._results))
                    self._obs["serve_engine_rebuilds_total"].inc()
                    self._event_log.emit(
                        "engine_rebuilt", inflight=len(self._results),
                        error=f"{type(exc).__name__}: {exc}"[:500])
                    # a failed step closed a record too: advance an armed
                    # capture so it never stays open
                    rec = self.stepstats.last_record
                    if (seq0 is not None and rec is not None
                            and rec.closed and rec.seq >= seq0):
                        self._profile_note_step(rec.seq)
                    try:
                        for req in self.engine.fail_outstanding("error"):
                            self._settle(req)
                    except Exception:  # noqa: BLE001 — refunds must
                        logger.exception("settling failed")  # not block
                    self._fail_pending(exc)
                    self._rebuild()
                    busy = False
            if not busy:
                # idle: park until a submit wakes the loop (a short
                # timeout keeps shutdown and /livez prompt)
                self.new_work.wait(0.05)
                self.new_work.clear()

    def stats(self) -> dict:
        with self._locked():
            return self.engine.stats

    def begin_drain(self) -> None:
        """Stop admission (every later submit gets 503); queued and
        in-slot requests decode to completion."""
        self.draining.set()
        self._obs["serve_draining"].set(1)

    def drain(self, timeout_s: float) -> bool:
        """Wait until every accepted request has its terminal and the
        engine is idle, or ``timeout_s`` passes; True when drained."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._locked():
                busy = self.engine.busy
                with self._results_lock:
                    pending = any(slot[1] is None and not slot[0].is_set()
                                  for slot in self._results.values())
            if not pending and not busy:
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.05)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Stop the engine thread and the watchdog, close a running
        profiler capture, settle the pipeline (every in-flight chunk
        collected and its finished requests delivered), then fail every
        waiter still pending with :class:`EngineShutdown`."""
        self.stop.set()
        self.new_work.set()
        self.thread.join(timeout_s)
        self._watchdog.join(timeout_s)
        self._stop_profile()
        with self.lock:
            try:
                self._deliver_finished(self.engine.quiesce())
            except Exception:  # noqa: BLE001 — the waiters fail below
                logger.exception("engine failed while quiescing")
            self._fail_pending(EngineShutdown(
                "serving front shut down while the request was in flight"))


class BundleServer:
    """Loads a bundle onto ``device`` and serves generate/score. With
    ``continuous_slots > 0`` a slot engine (``--continuous-slots``,
    ``--continuous-chunk``) serves greedy and temperature/top-p
    requests and the streams; ``prefill_chunk`` and
    ``step_token_budget`` are its chunked prefill (``--prefill-chunk``,
    ``--step-token-budget``), ``continuous_pipeline`` its decode-ahead
    depth (``--continuous-pipeline``, 1 by default), ``adaptive_chunk``
    its budget-aligned chunks (``--adaptive-chunk``),
    ``prefix_cache_size`` its radix cache's resident pages
    (``--prefix-cache``), ``spec_tokens`` its in-slot speculation
    (``--spec-tokens``) and ``schedule`` its admission order
    (``--schedule``). ``max_queue_depth``, ``max_queued_tokens`` and
    ``tenants_spec`` gate admission (``--max-queue-depth``,
    ``--max-queued-tokens``, ``--tenants``); ``role`` is the
    disaggregated serving role ``/loadz`` advertises (``--role``);
    ``live_stall_s`` the driver-loop age past which ``/livez`` answers
    503 (``--live-stall``); ``step_record_ring`` the ``/stepz`` ring's
    length (``--step-record-ring``). ``draft_bundle_dir``
    (``--draft-bundle``) is the draft of both speculative paths.

    The operator contract: ``registry`` and ``event_log`` (the process
    defaults when None) carry ``/metrics`` and ``/events``;
    ``trace_sample`` / ``trace_slow_ms`` the request tracer
    (``--trace-sample``, ``--trace-slow-ms``); ``step_timeout_s`` the
    step watchdog (``--step-timeout``); ``heartbeat_file`` the driver
    loop's heartbeat (``--heartbeat-file``); ``chaos_spec`` the fault
    injection (``--chaos``); ``admin_token`` gates ``/admin/reload`` and
    ``/admin/profile`` (``SERVE_ADMIN_TOKEN``); ``peak_flops`` the
    card's peak FLOPs/s, which arms the ``serve_mfu`` gauge
    (``--peak-flops``, 0 = off)."""

    def __init__(self, bundle_dir: str, device: str = "cuda",
                 continuous_slots: int = 0, continuous_chunk: int = 8,
                 int8_kv: bool = False, prefill_chunk: int = 0,
                 step_token_budget: int = 0, continuous_pipeline: int = 1,
                 adaptive_chunk: bool = False, prefix_cache_size: int = 0,
                 spec_tokens: int = 0, draft_bundle_dir: str = "",
                 schedule: str = "fifo", max_queue_depth: int = 0,
                 max_queued_tokens: int = 0, tenants_spec: str = "",
                 live_stall_s: float = 120.0, step_record_ring: int = 256,
                 role: str = "mixed", registry=None, event_log=None,
                 chaos_spec: str = "", heartbeat_file: str = "",
                 admin_token: str = "", trace_sample: float = 0.01,
                 trace_slow_ms: float = 1000.0,
                 step_timeout_s: float = 0.0, peak_flops: float = 0.0):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"role must be mixed, prefill or decode, got {role!r}")
        # advisory: the router sends long-prompt handoffs to `prefill`
        # replicas and generate traffic to the others; every role still
        # serves every endpoint
        self.role = role
        if prefill_chunk and not continuous_slots:
            raise ValueError(
                "--prefill-chunk requires --continuous-slots (chunked "
                "prefill is a slot-engine feature)")
        if prefix_cache_size and not continuous_slots:
            raise ValueError(
                "--prefix-cache requires --continuous-slots (the radix "
                "prefix cache lives in the slot engine's page pool)")
        # in-engine speculation: spec_tokens draft proposals a slot a
        # round, one multi-query verify; greedy token-exact against the
        # plain engine
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens and not continuous_slots:
            raise ValueError(
                "--spec-tokens requires --continuous-slots (in-engine "
                "speculation is a slot-engine feature; single-prompt "
                "whole-batch speculation rides --draft-bundle alone)")
        self.device = resolve_device(device)
        self._int8_kv = bool(int8_kv)
        # the shared metrics plane and event trail (/metrics, /events)
        self.registry = registry if registry is not None else get_registry()
        self._obs = platform_families(self.registry)
        install_runtime_metrics(self.registry)
        self.event_log = (event_log if event_log is not None
                          else get_event_log())
        # named-point chaos installs the process injector (it covers
        # bundle.load below); fail@N / slow@N:S drive the driver loop
        chaos = None
        if chaos_spec:
            chaos, named = split_serve_chaos_spec(chaos_spec)
            if named is not None:
                chaos_install(named)
                logger.warning("named-point chaos injection ACTIVE: %s",
                               named.describe())
        self.draft_bundle_dir = draft_bundle_dir or None
        self.draft_model = None
        if draft_bundle_dir:
            # the draft of both speculative paths: a smaller bundle of the
            # same tokenizer (a float16 one is refused by the loader)
            self.draft_model = retry_with_backoff(
                lambda: load_serving_bundle(draft_bundle_dir, self.device),
                op="bundle_load", give_up_on=_PERMANENT_LOAD_ERRORS)[0]
        self.model, self.meta, self.tokenizer = self._load_and_verify(
            bundle_dir)
        model = self.model
        if self.spec_tokens and self.draft_model is None:
            logger.warning(
                "--spec-tokens %d without --draft-bundle: SELF-draft mode "
                "(the draft forwards cost as much as the verify, and the "
                "dense draft cache costs memory; deploy a small draft "
                "bundle for the speedup)", self.spec_tokens)
        self.bundle_dir = bundle_dir
        # the serving generation (/healthz, /loadz, the
        # serve_bundle_generation gauge): it advances only after a hot
        # swap's canary passes; one reload at a time
        self.bundle_generation = int(self.meta.get("pipeline_generation", 1))
        self._obs["serve_bundle_generation"].set(self.bundle_generation)
        self.admin_token = admin_token
        self._reload_lock = threading.Lock()
        # request tracing: every POST gets a span (the caller's
        # traceparent adopted, else a new root); sample 0 and slow 0
        # keep only the ids
        self.tracer = TraceRecorder(
            sample=trace_sample, slow_ms=trace_slow_ms,
            counter=self._obs["serve_traces_recorded_total"])
        self._lock = threading.Lock()  # whole-batch generate and score
        # drain: admission stops, in-flight work finishes; /livez reads
        # the driver loop's age against live_stall_s
        self._draining = threading.Event()
        self._inflight_lock = threading.Lock()
        self._inflight_http = 0
        self._live_stall_s = float(live_stall_s)
        self._front: Optional[_ContinuousFront] = None
        self.stepstats = StepStatsRing(capacity=max(1, int(step_record_ring)))
        if continuous_slots > 0:
            # the driver loop beats the heartbeat (every 5th iteration:
            # the idle spin runs at ~20 Hz)
            heartbeat = (Heartbeat(heartbeat_file, every_steps=5)
                         if heartbeat_file else None)
            self._front = _ContinuousFront(
                model, tenants=tenants_spec, max_queue_depth=max_queue_depth,
                max_queued_tokens=max_queued_tokens, stepstats=self.stepstats,
                obs=self._obs, event_log=self.event_log, chaos=chaos,
                heartbeat=heartbeat, step_timeout_s=step_timeout_s,
                tracer=self.tracer,
                num_slots=continuous_slots, chunk=continuous_chunk,
                eos_token_id=getattr(self.tokenizer, "eos_id", None),
                pad_id=getattr(self.tokenizer, "pad_id", 0),
                prefill_chunk=prefill_chunk,
                step_token_budget=step_token_budget,
                pipeline_depth=continuous_pipeline,
                adaptive_chunk=adaptive_chunk,
                prefix_cache_size=prefix_cache_size, schedule=schedule,
                spec_tokens=self.spec_tokens,
                draft_model=self.draft_model if self.spec_tokens else None,
                peak_flops=float(peak_flops))

    # -- bundle loading and the hot swap ---------------------------------
    def _load_and_verify(self, bundle_dir: str):
        """``(model, meta, tokenizer)`` of one bundle: the one path of
        construction and :meth:`reload_bundle`. The load retries with
        backoff (``bundle.load`` chaos fires inside it); a missing path
        or a corrupt config fails at once."""
        def _load():
            chaos_fire("bundle.load", bundle=bundle_dir)
            return load_serving_bundle(bundle_dir, self.device)

        model, _, meta = retry_with_backoff(
            _load, op="bundle_load", give_up_on=_PERMANENT_LOAD_ERRORS)
        if self._int8_kv and not model.cfg.kv_cache_quant:
            # the cache layout is a serving-time choice (weights unchanged)
            cfg = dataclasses.replace(model.cfg, kv_cache_quant=True)
            for module in model.modules():
                if hasattr(module, "cfg"):
                    module.cfg = cfg
        tokenizer = get_tokenizer(meta.get("tokenizer", "byte"))
        if tokenizer.vocab_size > model.cfg.vocab_size:
            raise ValueError(
                f"bundle tokenizer vocab {tokenizer.vocab_size} exceeds "
                f"model vocab {model.cfg.vocab_size}")
        if (self.draft_model is not None
                and self.draft_model.cfg.vocab_size
                != model.cfg.vocab_size):
            raise ValueError(
                f"draft bundle vocab {self.draft_model.cfg.vocab_size} != "
                f"target vocab {model.cfg.vocab_size}")
        return model, meta, tokenizer

    def _check_swap_compat(self, meta: dict, model) -> None:
        """A hot-swapped bundle speaks the serving one's request
        contract: the same tokenizer spec and vocabulary (a request
        racing the swap may encode under one and decode under the
        other). Layers, widths and the KV layout may change: the engine
        is rebuilt around the new config."""
        old_spec = self.meta.get("tokenizer", "byte")
        new_spec = meta.get("tokenizer", "byte")
        if new_spec != old_spec:
            raise ValueError(
                f"incompatible bundle: tokenizer {new_spec!r} != "
                f"serving tokenizer {old_spec!r}")
        if model.cfg.vocab_size != self.model.cfg.vocab_size:
            raise ValueError(
                f"incompatible bundle: vocab {model.cfg.vocab_size} != "
                f"serving vocab {self.model.cfg.vocab_size}")

    def _install_bundle(self, model, meta, tokenizer, bundle_dir: str,
                        drain_s: float = 30.0) -> None:
        """Point the serving surfaces at a verified bundle: the
        whole-batch path under its lock, the slot engine through
        :meth:`_ContinuousFront.swap_model`."""
        with self._lock:
            self.model, self.meta = model, meta
            self.tokenizer, self.bundle_dir = tokenizer, bundle_dir
        if self._front is not None:
            self._front.swap_model(
                model, getattr(tokenizer, "eos_id", None),
                getattr(tokenizer, "pad_id", 0), drain_s=drain_s)

    def _canary(self) -> None:
        """One tiny generate through the freshly swapped bundle (past the
        admission gates on the slot engine): only after it returns does
        the advertised generation advance. On the card it is also the
        new engine's first busy step, which captures its graphs."""
        ids = self.tokenizer.encode("canary")
        if self._front is not None:
            rid = self._front.submit_internal(ids, 2)
            self._front.wait(rid, timeout_s=120)
            return
        out = self.generate(["canary"], max_new_tokens=2)
        if not out or "completion" not in out[0]:
            raise RuntimeError(f"canary generate returned {out!r}")

    def reload_bundle(self, bundle_dir: str, generation=None,
                      canary: bool = True, drain_s: float = 30.0) -> dict:
        """Hot swap to the bundle at ``bundle_dir`` (``POST
        /admin/reload``): load and verify (the boot path), the compat
        check, the swap (in-flight work drains on the old weights), the
        canary, then the generation advances. A load or compat failure
        swaps nothing; a canary failure reinstalls the previous bundle;
        both raise :class:`BundleReloadError` (502) with the old
        generation serving. One reload at a time
        (:class:`ReloadInFlight`, 409). ``timings_s`` in the reply has
        the load, swap and canary walls."""
        if generation is not None:
            # before any swap: a bad generation failing after the canary
            # would leave the new bundle serving under the old number
            try:
                generation = int(generation)
            except (TypeError, ValueError):
                raise ValueError(
                    f"'generation' must be an integer, got "
                    f"{generation!r}") from None
        if not self._reload_lock.acquire(blocking=False):
            raise ReloadInFlight(
                "a bundle reload is already in flight; retry after it "
                "settles")
        try:
            self.event_log.emit("bundle_reload_started", bundle=bundle_dir,
                                current_generation=self.bundle_generation)
            old = (self.model, self.meta, self.tokenizer, self.bundle_dir)
            t0 = time.perf_counter()
            try:
                model, meta, tokenizer = self._load_and_verify(bundle_dir)
                self._check_swap_compat(meta, model)
            except Exception as exc:
                self._obs["serve_bundle_reloads_total"].labels(
                    outcome="rejected").inc()
                self.event_log.emit(
                    "bundle_reload_failed", bundle=bundle_dir,
                    rolled_back=False,
                    error=f"{type(exc).__name__}: {exc}"[:500])
                raise BundleReloadError(
                    f"bundle rejected before swap: {exc}",
                    rolled_back=False) from exc
            t1 = time.perf_counter()
            self._install_bundle(model, meta, tokenizer, bundle_dir,
                                 drain_s=drain_s)
            del model  # the rollback below must leave no reference
            t2 = time.perf_counter()
            if canary:
                try:
                    self._canary()
                except Exception as exc:  # noqa: BLE001 — any canary
                    # failure leaves the OLD generation serving
                    logger.exception(
                        "canary generate failed after bundle swap; "
                        "rolling back to %s", old[3])
                    self._install_bundle(*old, drain_s=drain_s)
                    self._obs["serve_bundle_reloads_total"].labels(
                        outcome="rolled_back").inc()
                    self.event_log.emit(
                        "bundle_reload_rolled_back", bundle=bundle_dir,
                        restored=old[3],
                        error=f"{type(exc).__name__}: {exc}"[:500])
                    raise BundleReloadError(
                        f"canary generate failed (previous bundle "
                        f"restored): {exc}", rolled_back=True) from exc
            t3 = time.perf_counter()
            del old
            gen = (generation if generation is not None
                   else int(self.meta.get("pipeline_generation",
                                          self.bundle_generation + 1)))
            self.bundle_generation = gen
            self._obs["serve_bundle_generation"].set(gen)
            self._obs["serve_bundle_reloads_total"].labels(
                outcome="ok").inc()
            self.event_log.emit("bundle_reload_succeeded",
                                bundle=bundle_dir, generation=gen,
                                canary=bool(canary))
            logger.info("bundle hot-swapped: %s (generation %d)",
                        bundle_dir, gen)
            return {"ok": True, "bundle": bundle_dir,
                    "bundle_generation": gen, "canary": bool(canary),
                    "timings_s": {"load": round(t1 - t0, 4),
                                  "swap": round(t2 - t1, 4),
                                  "canary": round(t3 - t2, 4)}}
        finally:
            self._reload_lock.release()

    def start_profile(self, output_dir: Optional[str],
                      steps: int = 8) -> dict:
        """``POST /admin/profile``: arm a ``torch.profiler`` capture
        (CPU and, on the card, CUDA activity) over the next ``steps``
        busy engine steps, written as a Chrome trace into ``output_dir``
        (a fresh temporary directory when omitted; the reply names it).
        Completion lands on the event trail as ``profile_trace_written``
        with the step-seq window and recent trace ids.
        :class:`ProfileInFlight` (409) while a capture is armed; 400 on
        a whole-batch server (no step loop)."""
        if self._front is None:
            raise ValueError(
                "profiling requires --continuous-slots (the capture "
                "spans engine steps; whole-batch serving has no step "
                "loop)")
        if int(steps) < 1:
            raise ValueError(f"profile steps must be >= 1, got {steps}")
        if self._front.profile_in_flight():
            raise ProfileInFlight("a profiler capture is already in flight")
        created = None
        if not output_dir:
            output_dir = created = tempfile.mkdtemp(prefix="stepprof-")
        else:
            os.makedirs(output_dir, exist_ok=True)
        try:
            return self._front.start_profile(output_dir, steps)
        except ProfileInFlight:
            if created is not None:
                with contextlib.suppress(OSError):
                    os.rmdir(created)
            raise

    # -- lifecycle -------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        """Flip to draining: ``/healthz`` answers 503, new requests get
        503 with ``Retry-After``, in-flight requests keep decoding.
        Idempotent."""
        if self._draining.is_set():
            return
        self._draining.set()
        self._obs["serve_draining"].set(1)
        self.event_log.emit("serve_drain_started", bundle=self.bundle_dir)
        if self._front is not None:
            self._front.begin_drain()

    def _http_enter(self) -> None:
        with self._inflight_lock:
            self._inflight_http += 1

    def _http_exit(self) -> None:
        with self._inflight_lock:
            self._inflight_http -= 1

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait for every in-flight HTTP request and the slot engine to
        finish, up to ``timeout_s``; True when fully drained."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._inflight_lock:
                busy_http = self._inflight_http
            if not busy_http and (self._front is None
                                  or self._front.drain(timeout_s=0)):
                self.event_log.emit("serve_drain_finished", drained=True)
                return True
            if time.monotonic() >= deadline:
                self.event_log.emit("serve_drain_finished", drained=False,
                                    inflight_http=busy_http)
                return False
            time.sleep(0.05)

    def shutdown(self) -> None:
        if self._front is not None:
            self._front.shutdown()

    # -- health and load -------------------------------------------------
    def health(self) -> dict:
        return {
            "status": "draining" if self.draining else "ok",
            "bundle": self.bundle_dir,
            "bundle_generation": self.bundle_generation,
            "format": self.meta.get("format"),
            "model": self.meta.get("model"),
            "quantized": bool(self.meta.get("quantized")),
            "vocab_size": self.model.cfg.vocab_size,
            "max_seq_len": self.model.cfg.max_seq_len,
            "tokenizer": self.meta.get("tokenizer", "byte"),
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "speculative_draft": self.draft_bundle_dir,
            "draining": self.draining,
            "admission": ({"max_queue_depth": self._front.max_queue_depth,
                           "max_queued_tokens":
                               self._front.max_queued_tokens}
                          if self._front is not None else None),
            "continuous": (self._front.stats()
                           if self._front is not None else None),
        }

    def livez(self) -> dict:
        """Liveness (``GET /livez``), taking no lock: ``live`` goes false
        only when the engine's driver loop has not finished an iteration
        for ``live_stall_s``; ``wedged`` reports a step the watchdog is
        reaping. Draining and load are readiness, not liveness; a
        whole-batch server is always live."""
        out = {"live": True, "draining": self.draining}
        front = self._front
        if front is not None:
            age = time.monotonic() - front._last_loop_ts
            out["driver_loop_age_s"] = round(age, 3)
            out["wedged"] = bool(front._wedged)
            out["step_timeout_s"] = front.step_timeout_s
            if self._live_stall_s and age > self._live_stall_s:
                out["live"] = False
        return out

    def loadz(self) -> dict:
        """The load snapshot the router's prober polls (``GET /loadz``).
        Its key set is the JAX server's, a contract: the router scores
        on ``queued_tokens`` / ``active``, gates on ``draining`` and
        ``role``, and reads ``capacity_free`` (the tighter of the
        queued-token budget and the free pages' tokens; a dense engine
        without a queued-token bound: free slots x ``max_seq_len``),
        ``queue_delay_ms``, ``tenants`` and the step telemetry. A
        whole-batch server reports zeros, a dense engine
        ``kv_pages_free`` None."""
        with self._inflight_lock:
            inflight_http = self._inflight_http
        out = {
            "queued": 0, "queued_tokens": 0, "active": 0, "slots_total": 0,
            "kv_pages_free": None, "inflight_http": inflight_http,
            "draining": self.draining,
            "bundle_generation": self.bundle_generation,
            "role": self.role,
            "prefix_cache_pages": 0, "prefix_hit_rate": 0.0,
            "capacity_free": 0, "queue_delay_ms": 0.0, "tenants": {},
            "spec_accept_rate": 0.0, "step_host_overhead_frac": 0.0,
            "step_tokens_per_sec": 0.0,
        }
        if self._front is None:
            return out
        stats = self._front.stats()
        out["queued"] = stats["queued"]
        out["queued_tokens"] = stats["queued_tokens"]
        out["active"] = stats["active"]
        out["slots_total"] = stats["num_slots"]
        out["queue_delay_ms"] = stats["queue_delay_ms"]
        paged = stats.get("paged")
        caps = []
        if paged:
            out["kv_pages_free"] = (paged["pages_total"]
                                    - paged["pages_in_use"])
            caps.append(out["kv_pages_free"] * paged["page_size"])
        cache = stats.get("prefix_cache")
        if cache:
            out["prefix_cache_pages"] = int(cache.get("resident_pages", 0))
            out["prefix_hit_rate"] = float(cache.get("recent_hit_rate", 0.0))
        if self._front.max_queued_tokens:
            caps.append(self._front.max_queued_tokens
                        - stats["queued_tokens"])
        if not caps:  # dense and unbounded: crude, monotone in headroom
            caps.append((stats["num_slots"] - stats["active"])
                        * self.model.cfg.max_seq_len)
        out["capacity_free"] = max(0, min(caps))
        self._obs["serve_capacity_free_tokens"].set(out["capacity_free"])
        if self.spec_tokens:
            out["spec_accept_rate"] = stats["spec"]["recent_accept_rate"]
        phases = stats["step_phases"]
        out["step_host_overhead_frac"] = phases["host_overhead_frac"]
        out["step_tokens_per_sec"] = phases.get("tokens_per_sec") or 0.0
        out["tenants"] = {name: {"queued": t["queued"],
                                 "queued_tokens": t["queued_tokens"]}
                          for name, t in stats["tenants"].items()}
        for name, t in stats["tenants"].items():
            self._obs["serve_tenant_queue_depth"].labels(
                tenant=name).set(t["queued"])
        return out

    # -- generation ------------------------------------------------------
    def _entry(self, prompt: str, new_tokens: List[int], dt_ms: float,
               eos_id, **extra) -> dict:
        if eos_id is not None and eos_id in new_tokens:
            new_tokens = new_tokens[:new_tokens.index(eos_id)]
        return {
            "prompt": prompt,
            "completion": prompt + self.tokenizer.decode(new_tokens),
            "new_tokens": len(new_tokens),
            "latency_ms": round(dt_ms, 2),
            **extra,
        }

    def generate(self, prompts, max_new_tokens: int = 64,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 num_beams: int = 0, repetition_penalty=None,
                 deadline_s=None, tenant: str = "default",
                 seed=None, span=None) -> list:
        """Batch completion, results in input order. Slot-engine
        requests draw their sampling lane from ``seed + index`` when the
        client pins ``seed`` (deterministic per prompt and seed).
        ``deadline_s`` (seconds from now): the slot engine expires the
        request at a chunk boundary, the whole-batch path checks between
        length groups; both raise :class:`DeadlineExceeded`. ``tenant``
        is the fairness identity of the slot engine's requests, ``span``
        their trace span. ``num_beams > 1`` runs beam search on the
        whole-batch path (each entry gains ``beam_score``)."""
        if self.draining:
            self._obs["serve_requests_rejected_total"].labels(
                reason="draining").inc()
            raise _draining_rejection()
        t_deadline = None
        if deadline_s is not None:
            if deadline_s <= 0:
                self._obs["serve_request_deadline_exceeded_total"].inc()
                raise DeadlineExceeded(
                    f"deadline of {deadline_s * 1000.0:.0f}ms already "
                    "expired at submission")
            t_deadline = time.monotonic() + float(deadline_s)
        if not prompts:
            return []
        if len(prompts) > MAX_BATCH:
            raise ValueError(f"batch of {len(prompts)} exceeds max batch "
                             f"{MAX_BATCH}")
        cfg = self.model.cfg
        eos_id = getattr(self.tokenizer, "eos_id", None)
        encoded = []
        for i, text in enumerate(prompts):
            ids = self.tokenizer.encode(text)
            if not ids:
                raise ValueError(f"prompt {i} tokenized to zero tokens")
            if len(ids) + max_new_tokens > cfg.max_seq_len:
                raise ValueError(
                    f"prompt {i}: {len(ids)} tokens + {max_new_tokens} new "
                    f"exceeds max_seq_len {cfg.max_seq_len}")
            encoded.append((i, ids))
        engine_ok = (not num_beams and repetition_penalty is None
                     and top_k is None)
        plain_greedy = (engine_ok and top_p is None
                        and not (temperature and temperature > 0))
        # Routing for plain-greedy traffic: the standalone speculative
        # path (a draft is loaded, one prompt that fits the draft's
        # context, no deadline — the spec loop has no chunk boundary to
        # cancel at — and the engine does not speculate itself) -> the
        # slot engine -> whole-batch generate
        could_spec = (self.draft_model is not None and len(prompts) == 1
                      and plain_greedy and deadline_s is None
                      and not (self.spec_tokens and self._front is not None)
                      and len(encoded[0][1]) + max_new_tokens
                      <= self.draft_model.cfg.max_seq_len)
        if could_spec:
            ids = encoded[0][1]
            with self._lock:
                t0 = time.perf_counter()
                out, stats = speculative_generate(
                    self.model, self.draft_model, np.asarray([ids]),
                    max_new_tokens, gamma=SPEC_GAMMA, eos_token_id=eos_id,
                    return_stats=True)
                dt = (time.perf_counter() - t0) * 1000.0
            return [self._entry(
                prompts[0], out[0, len(ids):].tolist(), dt, eos_id,
                speculative={
                    "gamma": SPEC_GAMMA,
                    "acceptance_rate": round(
                        stats["accepted"] / max(stats["proposed"], 1), 3),
                    "tokens_per_round": round(stats["tokens_per_round"], 2),
                })]
        if self._front is not None and engine_ok:
            t0 = time.perf_counter()
            temp = float(temperature or 0.0)
            rids = []
            try:
                for i, ids in encoded:
                    rids.append((i, self._front.submit(
                        ids, max_new_tokens, temperature=temp, top_p=top_p,
                        seed=(int(seed) + i if seed is not None else
                              int.from_bytes(os.urandom(4), "little")),
                        deadline_s=deadline_s, tenant=tenant, span=span)))
            except Exception:
                # a rejection mid-batch must not strand the rows before it
                for _, rid in rids:
                    self._front.abandon(rid)
                raise
            toks = {}
            try:
                for i, rid in rids:
                    toks[i] = self._front.wait(rid)
            except Exception:
                for i, rid in rids:
                    if i not in toks:
                        self._front.abandon(rid)
                raise
            dt = (time.perf_counter() - t0) * 1000.0
            return [self._entry(prompts[i], toks[i], dt, eos_id)
                    for i, _ in rids]

        groups: Dict[int, list] = {}
        for i, ids in encoded:
            groups.setdefault(len(ids), []).append((i, ids))
        results = [None] * len(prompts)
        sampling = bool(temperature and temperature > 0)
        with self._lock:
            for length, members in sorted(groups.items()):
                if t_deadline is not None and time.monotonic() > t_deadline:
                    # whole-batch granularity: between length groups
                    self._obs["serve_request_deadline_exceeded_total"].inc()
                    raise DeadlineExceeded(
                        "request deadline exceeded before the batch "
                        "finished decoding")
                rows = np.asarray([ids for _, ids in members], np.int64)
                t0 = time.perf_counter()
                scores = None
                if num_beams and num_beams > 1:
                    out, scores = beam_search(
                        self.model, rows, max_new_tokens,
                        num_beams=num_beams, eos_token_id=eos_id)
                    scores = scores.cpu().numpy()
                else:
                    gen = None
                    if sampling:
                        gen = torch.Generator(
                            device=self.device).manual_seed(
                                int(seed) % (1 << 64) if seed is not None
                                else int.from_bytes(os.urandom(4),
                                                    "little"))
                    out = generate(self.model, rows,
                                   max_new_tokens=max_new_tokens,
                                   temperature=float(temperature or 0.0),
                                   generator=gen, eos_token_id=eos_id,
                                   top_k=top_k, top_p=top_p,
                                   repetition_penalty=repetition_penalty)
                toks = out[:, length:].cpu().numpy()
                dt = (time.perf_counter() - t0) * 1000.0
                for row, (i, _) in enumerate(members):
                    extra = ({"beam_score": float(scores[row])}
                             if scores is not None else {})
                    results[i] = self._entry(prompts[i], toks[row].tolist(),
                                             dt, eos_id, **extra)
        return results

    def generate_stream(self, prompt: str, max_new_tokens: int = 64,
                        deadline_s=None, tenant: str = "default",
                        continuation=None, span=None):
        """Greedy streaming through the slot engine: yields one event a
        collected token group (``token_ids`` and the whole ``text`` so
        far, so a multibyte sequence never tears), then the terminal
        entry. ``continuation`` (``{"emitted_ids": [...]}``) is the
        router's failover splice: ``prompt`` is the original prompt and
        ``emitted_ids`` what a dead replica already delivered; the
        engine prefills ``encode(prompt) + emitted_ids`` (token ids, not
        re-tokenized text) and events and the terminal frame text and
        counts cumulatively, so the spliced stream reads as one run."""
        if self._front is None:
            raise ValueError(
                "streaming requires --continuous-slots (the slot engine "
                "is what yields tokens as they decode)")
        if deadline_s is not None and deadline_s <= 0:
            self._obs["serve_request_deadline_exceeded_total"].inc()
            raise DeadlineExceeded(
                f"deadline of {deadline_s * 1000.0:.0f}ms already "
                "expired at submission")
        ids = self.tokenizer.encode(prompt)
        if not ids:
            raise ValueError("prompt tokenized to zero tokens")
        prior_ids: list = []
        if continuation is not None:
            prior_ids = [int(t) for t in continuation["emitted_ids"]]
            ids = ids + prior_ids
            if span is not None:
                # the resume crosses replicas inside one trace
                span.event("continuation", emitted_tokens=len(prior_ids))
        cfg = self.model.cfg
        if len(ids) + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"{len(ids)} tokens + {max_new_tokens} new exceeds "
                f"max_seq_len {cfg.max_seq_len}")
        eos_id = getattr(self.tokenizer, "eos_id", None)
        t0 = time.perf_counter()
        rid, q = self._front.submit_stream(ids, max_new_tokens,
                                           deadline_s=deadline_s,
                                           tenant=tenant, span=span)
        toks, finished, yielded = [], False, False
        try:
            while True:
                item = q.get(timeout=600)
                if isinstance(item, Exception):
                    if isinstance(item, (DeadlineExceeded, EngineShutdown,
                                         RequestRejected)):
                        raise item
                    raise RuntimeError(
                        f"continuous engine failed this request: {item}")
                if item == []:
                    break
                if eos_id is not None and eos_id in item:
                    item = item[:item.index(eos_id)]
                    toks.extend(item)
                    if item:
                        yielded = True
                        yield {"token_ids": item,
                               "text": prompt + self.tokenizer.decode(
                                   prior_ids + toks)}
                    break
                toks.extend(item)
                yielded = True
                yield {"token_ids": item,
                       "text": prompt + self.tokenizer.decode(
                           prior_ids + toks)}
            # release the results entry (its event is set by now)
            self._front.wait(rid, timeout_s=60)
            finished = True
        finally:
            if not finished:
                # a client gone mid-stream, or a failure: free the slot
                self._front.abandon(rid)
                exc_type = sys.exc_info()[0]
                if not (not yielded and exc_type is not None
                        and issubclass(exc_type, (DeadlineExceeded,
                                                  RequestRejected))):
                    # past the 200 (or an engine failure): /metrics is
                    # where this failure still shows; a shed or expiry
                    # before the first event is the handler's to count
                    self.record_metrics(failed=True)
        entry = {
            "prompt": prompt,
            "completion": prompt + self.tokenizer.decode(prior_ids + toks),
            "new_tokens": len(prior_ids) + len(toks),
            "latency_ms": round((time.perf_counter() - t0) * 1000.0, 2),
            "done": True,
        }
        if continuation is not None:
            entry["resumed"] = True
        # this replica's tokens only (a continuation's prior tokens were
        # another replica's work)
        self.record_metrics(
            generate_entries=[{**entry, "new_tokens": len(toks)}],
            trace_id=span.trace_id if span is not None else None)
        yield entry

    # -- prefix warming and the disaggregated KV handoff -----------------
    def warm_prefix(self, prefix: str) -> dict:
        """``POST /v1/warm``: prefill a shared prefix into the radix
        cache, so later prompts starting with it skip that prefill."""
        if self._front is None:
            raise ValueError("warming requires --continuous-slots")
        ids = self.tokenizer.encode(prefix)
        if not ids:
            raise ValueError("prefix tokenized to zero tokens")
        n = self._front.warm_prefix(ids)
        return {"prefix_tokens": n,
                "prefix_cache": self._front.stats().get("prefix_cache")}

    def prefill_export(self, prompt: str) -> dict:
        """``POST /v1/prefill``: prefill the prompt into the radix cache
        and export its full KV pages as one base64 ``.npz`` blob (the
        prefill replica's half of a handoff; the router ships it to a
        decode replica's ``/v1/kv_import``). A prompt under one page has
        nothing to transfer: ``blob`` is null."""
        if self._front is None:
            raise ValueError("KV export requires --continuous-slots")
        ids = self.tokenizer.encode(prompt)
        if not ids:
            raise ValueError("prompt tokenized to zero tokens")
        warmed = self._front.warm_prefix(ids)
        export = self._front.export_prefix_pages(ids)
        if export is None:
            return {"prefix_tokens": warmed, "page_size": 0,
                    "pages": 0, "blob": None}
        blob = pack_kv_export(export)
        self._obs["serve_kv_xfer_bytes_total"].inc(len(blob))
        return {
            "prefix_tokens": warmed,
            "page_size": export["page_size"],
            "pages": len(export["token_ids"]) // export["page_size"],
            "blob": base64.b64encode(blob).decode("ascii"),
        }

    def kv_import(self, blob_b64: str) -> dict:
        """``POST /v1/kv_import``: install a transferred page blob into
        the pool and adopt it into the radix trie (the decode replica's
        half; idempotent). Blobs cross packages: either one's export
        imports into the other."""
        if self._front is None:
            raise ValueError("KV import requires --continuous-slots")
        data = base64.b64decode(blob_b64.encode("ascii"), validate=True)
        self._obs["serve_kv_xfer_bytes_total"].inc(len(data))
        transfer = unpack_kv_blob(data)
        ps = self.model.cfg.kv_page_size
        if transfer["page_size"] != ps:
            raise ValueError(
                f"KV transfer page_size {transfer['page_size']} does "
                f"not match this replica's kv_page_size {ps} — "
                "role-split fleets must serve one bundle shape")
        imported = self._front.import_prefix_pages(transfer["token_ids"],
                                                   transfer["layers"])
        return {"imported_tokens": imported, "pages": imported // ps}

    # -- metrics ---------------------------------------------------------
    def record_metrics(self, *, generate_entries=None, score: bool = False,
                       failed: bool = False,
                       trace_id: Optional[str] = None) -> None:
        """Fold one request into the registry (thread-safe: each metric
        holds its own lock). ``trace_id`` rides the latency histogram as
        its bucket's exemplar (``/metrics.json``)."""
        m = self._obs
        m["serve_requests_total"].inc()
        if failed:
            m["serve_requests_failed_total"].inc()
        if score:
            m["serve_score_requests_total"].inc()
        if generate_entries:
            m["serve_generate_requests_total"].inc()
            m["serve_generate_tokens_total"].inc(sum(
                e.get("new_tokens", 0) for e in generate_entries))
            m["serve_generate_latency_ms"].observe(max(
                (e.get("latency_ms", 0.0) for e in generate_entries),
                default=0.0), exemplar=trace_id)

    def _legacy_metrics_text(self) -> str:
        """The JAX server's pre-registry exposition names
        (``pyspark_tf_gke_tpu_serve_*``), aliased onto registry values."""
        m = self._obs
        alias = [
            ("requests_total", "counter", m["serve_requests_total"].value),
            ("requests_failed_total", "counter",
             m["serve_requests_failed_total"].value),
            ("generate_tokens_total", "counter",
             m["serve_generate_tokens_total"].value),
            ("generate_latency_ms_sum", "counter",
             m["serve_generate_latency_ms"].sum),
            ("generate_requests_total", "counter",
             m["serve_generate_requests_total"].value),
            ("score_requests_total", "counter",
             m["serve_score_requests_total"].value),
        ]
        lines = []
        for key, kind, val in alias:
            name = f"pyspark_tf_gke_tpu_serve_{key}"
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} "
                         f"{int(val) if float(val).is_integer() else val}")
        if self._front is not None:
            stats = self._front.stats()
            for key in ("queued", "active", "finished", "num_slots"):
                name = f"pyspark_tf_gke_tpu_serve_continuous_{key}"
                kind = "counter" if key == "finished" else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {stats[key]}")
            for key, val in (stats.get("prefix_cache") or {}).items():
                if not isinstance(val, (int, float)):
                    continue  # a tag, not a number
                name = ("pyspark_tf_gke_tpu_serve_continuous_"
                        f"prefix_cache_{key}")
                kind = ("counter" if key in ("hits", "misses",
                                             "hit_tokens", "evictions")
                        else "gauge")
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"

    def _refresh_engine_gauges(self) -> None:
        """Scrape-time refresh of the engine gauges (the engine sets
        them only at collect boundaries)."""
        if self._front is not None:
            stats = self._front.stats()
            self._obs["serve_slots_total"].set(stats["num_slots"])
            self._obs["serve_slots_active"].set(stats["active"])
            self._obs["serve_queue_depth"].set(stats["queued"])
            for name, t in (stats.get("tenants") or {}).items():
                self._obs["serve_tenant_queue_depth"].labels(
                    tenant=name).set(t["queued"])

    def metrics_text(self) -> str:
        """The Prometheus exposition: the registry (``train_`` /
        ``serve_`` / ``runtime_`` families) plus the alias block."""
        self._refresh_engine_gauges()
        return self.registry.exposition() + self._legacy_metrics_text()

    # -- scoring ---------------------------------------------------------
    def score(self, texts, tenant: str = "default") -> list:
        """Per-text total NLL in nats and the scored token count. Texts
        longer than max_seq_len are truncated (``truncated``); texts
        under 2 tokens come back ``{"skipped": true, "tokens": 0}``. With
        a tenant spec the batch's tokens are charged to the tenant's
        bucket up front (no refund)."""
        if not texts:
            return []
        if len(texts) > MAX_BATCH:
            raise ValueError(f"batch of {len(texts)} exceeds max batch "
                             f"{MAX_BATCH}")
        cap = self.model.cfg.max_seq_len
        results: list = [None] * len(texts)
        rows = []
        for i, text in enumerate(texts):
            ids = self.tokenizer.encode(text)
            if len(ids) < 2:
                results[i] = {"nll": 0.0, "tokens": 0, "truncated": False,
                              "skipped": True}
                continue
            rows.append((i, ids[:cap], len(ids) > cap))
        if rows and self._front is not None:
            self._front.charge_tokens(
                tenant, sum(len(ids) for _, ids, _ in rows))
        if rows:
            # right padding to the longest text: causal attention keeps
            # every real position blind to the padding after it
            lengths = [len(ids) for _, ids, _ in rows]
            padded = np.zeros((len(rows), max(lengths)), np.int64)
            for r, (_, ids, _) in enumerate(rows):
                padded[r, :len(ids)] = ids
            with self._lock:
                nlls = serve_score(self.model, padded, lengths)
            for r, (i, ids, trunc) in enumerate(rows):
                results[i] = {"nll": float(nlls[r]), "tokens": len(ids) - 1,
                              "truncated": trunc}
        return results


def _span_shed_event(span, exc: RequestRejected) -> None:
    """The shed verdict on the request's span, unless the span already
    has its terminal: a reload past its drain bound hands an ADMITTED
    request a 'reloading' shed whose terminal the engine stamped, and a
    second verdict would read as a double delivery."""
    if span is None:
        return
    if any(e.get("name") == "terminal" for e in span.events):
        return
    span.event("shed", reason=exc.reason,
               **({"tenant": exc.tenant} if exc.tenant else {}))


def _shed_headers(exc: RequestRejected):
    """``Retry-After`` always; a per-tenant shed also ``X-Tenant-Shed``,
    so the router keeps the replica in rotation."""
    hdrs = [("Retry-After", str(exc.retry_after_s))]
    if exc.tenant:
        hdrs.append(("X-Tenant-Shed", str(exc.tenant)))
    return tuple(hdrs)


def _shed_body(exc: RequestRejected) -> dict:
    body = {"error": str(exc), "reason": exc.reason}
    if exc.tenant:
        body["tenant"] = exc.tenant
    return body


def _admin_token_error(server: BundleServer, headers):
    """The admin endpoints' token gate: without ``SERVE_ADMIN_TOKEN``
    the endpoint is disabled (403); with one, ``X-Admin-Token`` must
    match it (compared in constant time; 401). ``(status, body)``, or
    None when authorised."""
    if not server.admin_token:
        return 403, {"error": "admin endpoint disabled (set "
                              "SERVE_ADMIN_TOKEN to enable)"}
    if not hmac.compare_digest(headers.get("X-Admin-Token") or "",
                               server.admin_token):
        return 401, {"error": "bad or missing X-Admin-Token"}
    return None


def _make_handler(server: BundleServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        _span = None  # the request's trace span (POST paths set it)

        def log_message(self, fmt, *args):  # quiet per-request logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: dict, headers=()) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if self._span is not None:
                # every response, sheds included, echoes the trace id
                self.send_header("X-Request-Id", self._span.trace_id)
                self._span.set("http.status", code)
            for name, value in headers:
                self.send_header(name, value)
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(data)

        def _stream_generate(self, req, prompts, tenant):
            """Server-sent events: a ``: trace_id=`` comment, then
            ``data: {json}\\n\\n`` a token group, the terminal entry, and
            ``data: [DONE]\\n\\n``; the connection closes at the end.
            Greedy, one prompt. Errors found before the first event
            answer with a status; after it an ``{"error": ...}`` event
            ends the stream."""
            if len(prompts) != 1:
                server.record_metrics(failed=True)
                return self._reply(
                    400, {"error": "streaming takes exactly one prompt"})
            if (float(req.get("temperature", 0.0) or 0.0) > 0
                    or req.get("num_beams") or req.get("top_k")
                    or req.get("top_p") or req.get("repetition_penalty")):
                server.record_metrics(failed=True)
                return self._reply(
                    400, {"error": "streaming is greedy-only (no "
                                   "sampling/beam parameters)"})
            deadline_ms = req.get("deadline_ms")
            continuation = req.get("continuation")
            if continuation is not None:
                try:
                    emitted = [int(t) for t in continuation["emitted_ids"]]
                    if not emitted or any(t < 0 for t in emitted):
                        raise ValueError
                    continuation = {"emitted_ids": emitted}
                except (TypeError, KeyError, ValueError):
                    server.record_metrics(failed=True)
                    return self._reply(
                        400, {"error": "'continuation' must carry "
                                       "emitted_ids: a non-empty list "
                                       "of non-negative token ids"})
            events = None
            try:
                events = server.generate_stream(
                    prompts[0],
                    max_new_tokens=int(req.get("max_new_tokens", 64)),
                    deadline_s=(float(deadline_ms) / 1000.0
                                if deadline_ms is not None else None),
                    tenant=tenant, continuation=continuation,
                    span=self._span)
                # validation errors surface before the status line
                first = next(events)
            except RequestRejected as exc:
                _span_shed_event(self._span, exc)
                server.record_metrics()
                return self._reply(exc.status, _shed_body(exc),
                                   headers=_shed_headers(exc))
            except DeadlineExceeded as exc:
                server.record_metrics()
                return self._reply(504, {"error": str(exc)})
            except (TypeError, ValueError) as exc:
                server.record_metrics(failed=True)
                return self._reply(400, {"error": str(exc)})
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            if self._span is not None:
                self.send_header("X-Request-Id", self._span.trace_id)
                self._span.set("http.status", 200)
            self.end_headers()
            try:
                if self._span is not None:
                    # a comment carrying the trace id, for SSE clients
                    # that never see the response headers
                    self.wfile.write(
                        f": trace_id={self._span.trace_id}\n\n".encode())
                for event in itertools.chain([first], events):
                    self.wfile.write(
                        f"data: {json.dumps(event)}\n\n".encode())
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except Exception as exc:  # noqa: BLE001 — mid-stream: the
                # status line is gone; an error event if the socket still
                # listens, else the client sees the cut
                logger.warning("stream ended mid-flight: %s", exc)
                try:
                    self.wfile.write(
                        f"data: {json.dumps({'error': str(exc)})}"
                        "\n\n".encode())
                    self.wfile.write(b"data: [DONE]\n\n")
                except OSError:
                    pass
            finally:
                events.close()  # an unfinished stream frees its slot now

        def do_GET(self):
            route = self.path.partition("?")[0]
            if route in ("/healthz", "/health", "/"):
                # draining -> 503: readiness fails, routing stops
                return self._reply(503 if server.draining else 200,
                                   server.health())
            if route == "/livez":
                out = server.livez()
                return self._reply(200 if out["live"] else 503, out)
            if route == "/loadz":
                # draining answers 200: the field carries the state
                return self._reply(200, server.loadz())
            # /metrics is the server's exposition; /metrics.json, /events,
            # /traces, /stepz: the obs package assembles the reply
            if route == "/metrics":
                out = (200, PROMETHEUS_CONTENT_TYPE,
                       server.metrics_text().encode())
            else:
                out = handle_obs_request(self.path, server.registry,
                                         server.event_log,
                                         tracer=server.tracer,
                                         stepstats=server.stepstats)
            if out is None:
                return self._reply(404,
                                   {"error": f"unknown path {self.path}"})
            code, ctype, body = out
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            server._http_enter()  # drain() waits for this to reach zero
            # adopt the caller's traceparent (the router's, or a
            # client's) or mint a root; a malformed one mints a root
            self._span = server.tracer.start_span(
                "serve.request", parent=self.headers.get("traceparent"),
                attrs={"path": self.path.partition("?")[0]})
            try:
                with use_span(self._span):
                    self._do_post()
            finally:
                self._span.finish()
                # a handler lives per keep-alive connection: a later GET
                # on the socket must not echo this finished span
                self._span = None
                server._http_exit()

        def _do_post(self):
            if server.draining:
                # shed before reading the body: the connection closes
                self.close_connection = True
                server.record_metrics()
                server._obs["serve_requests_rejected_total"].labels(
                    reason="draining").inc()
                exc = _draining_rejection()
                self._span.event("shed", reason=exc.reason)
                return self._reply(exc.status, _shed_body(exc),
                                   headers=_shed_headers(exc))
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                server.record_metrics(failed=True)
                return self._reply(400, {"error": "bad Content-Length"})
            if length > MAX_BODY_BYTES:
                self.close_connection = True
                server.record_metrics(failed=True)
                return self._reply(413, {"error": "request body too large"})
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
            except ValueError as exc:
                server.record_metrics(failed=True)
                return self._reply(400, {"error": f"bad JSON body: {exc}"})
            try:
                # chaos: the request front's fault point (a fail rule is
                # a 500 terminal, a slow rule front latency)
                chaos_fire("serve.request")
                deadline_ms = req.get("deadline_ms")
                deadline_s = (float(deadline_ms) / 1000.0
                              if deadline_ms is not None else None)
                # the X-Tenant header wins, then the body's "tenant"
                tenant = (self.headers.get("X-Tenant") or req.get("tenant")
                          or "default")
                if not isinstance(tenant, str):
                    server.record_metrics(failed=True)
                    return self._reply(
                        400, {"error": "'tenant' must be a string"})
                if self.path == "/v1/generate":
                    prompts = req.get("prompts")
                    if prompts is None and "prompt" in req:
                        prompts = [req["prompt"]]
                    if not isinstance(prompts, list) or not all(
                            isinstance(p, str) for p in prompts or [None]):
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'prompts' must be a list of "
                                           "strings (or 'prompt': str)"})
                    seed = req.get("seed")
                    if seed is not None:
                        try:
                            seed = int(seed)
                        except (TypeError, ValueError):
                            server.record_metrics(failed=True)
                            return self._reply(
                                400, {"error": "'seed' must be an integer"})
                    if req.get("stream"):
                        return self._stream_generate(req, prompts, tenant)
                    out = server.generate(
                        prompts,
                        max_new_tokens=int(req.get("max_new_tokens", 64)),
                        temperature=float(req.get("temperature", 0.0)),
                        top_k=req.get("top_k"), top_p=req.get("top_p"),
                        num_beams=int(req.get("num_beams", 0)),
                        repetition_penalty=req.get("repetition_penalty"),
                        deadline_s=deadline_s, tenant=tenant, seed=seed,
                        span=self._span)
                    server.record_metrics(generate_entries=out,
                                          trace_id=self._span.trace_id)
                    self._reply(200, {"completions": out})
                elif self.path == "/v1/score":
                    texts = req.get("texts")
                    if not isinstance(texts, list) or not all(
                            isinstance(t, str) for t in texts or [None]):
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'texts' must be a list of "
                                           "strings"})
                    scores = server.score(texts, tenant)
                    server.record_metrics(score=True)
                    self._reply(200, {"scores": scores})
                elif self.path == "/v1/warm":
                    prefix = req.get("prefix")
                    if not isinstance(prefix, str):
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'prefix' must be a string"})
                    out = server.warm_prefix(prefix)
                    server.record_metrics()
                    self._reply(200, out)
                elif self.path == "/v1/prefill":
                    prompt = req.get("prompt")
                    if not isinstance(prompt, str):
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'prompt' must be a string"})
                    out = server.prefill_export(prompt)
                    server.record_metrics()
                    self._reply(200, out)
                elif self.path == "/v1/kv_import":
                    blob = req.get("blob")
                    if not isinstance(blob, str):
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'blob' must be a base64 "
                                           "string"})
                    out = server.kv_import(blob)
                    server.record_metrics()
                    self._reply(200, out)
                elif self.path == "/admin/reload":
                    err = _admin_token_error(server, self.headers)
                    if err is not None:
                        server.record_metrics()
                        server._obs["serve_bundle_reloads_total"].labels(
                            outcome="rejected").inc()
                        return self._reply(*err)
                    bundle = req.get("bundle")
                    if not isinstance(bundle, str) or not bundle:
                        server.record_metrics(failed=True)
                        return self._reply(
                            400, {"error": "'bundle' must be a bundle "
                                           "directory path"})
                    out = server.reload_bundle(
                        _resolve_bundle(bundle),
                        generation=req.get("generation"),
                        canary=bool(req.get("canary", True)))
                    server.record_metrics()
                    self._reply(200, out)
                elif self.path == "/admin/profile":
                    # 202: the capture is ARMED; profile_trace_written
                    # lands on /events when it is written
                    err = _admin_token_error(server, self.headers)
                    if err is not None:
                        server.record_metrics()
                        return self._reply(*err)
                    out = server.start_profile(
                        req.get("output_dir"),
                        steps=int(req.get("steps", 8)))
                    server.record_metrics()
                    self._reply(202, out)
                else:
                    server.record_metrics(failed=True)
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except RequestRejected as exc:
                # a shed is not a server fault: counted where it was
                # raised, in serve_requests_rejected_total
                server.record_metrics()
                _span_shed_event(self._span, exc)
                self._reply(exc.status, _shed_body(exc),
                            headers=_shed_headers(exc))
            except DeadlineExceeded as exc:
                server.record_metrics()
                self._reply(504, {"error": str(exc)})
            except ReloadInFlight as exc:
                server.record_metrics()
                server._obs["serve_bundle_reloads_total"].labels(
                    outcome="rejected").inc()
                self._reply(409, {"error": str(exc)})
            except ProfileInFlight as exc:
                server.record_metrics()
                self._reply(409, {"error": str(exc)})
            except BundleReloadError as exc:
                # the old generation serves either way; the body says
                # whether a swap happened and was rolled back
                server.record_metrics(failed=True)
                self._reply(502, {
                    "error": str(exc), "rolled_back": exc.rolled_back,
                    "bundle_generation": server.bundle_generation})
            except (TypeError, ValueError) as exc:
                # caller error, not a server fault
                server.record_metrics(failed=True)
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 — keep the server up
                logger.exception("request failed")
                server.record_metrics(failed=True)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # a burst of connections (a router's flood) queues in the listen
    # backlog instead of overflowing socketserver's default of 5 into
    # reset connections
    request_queue_size = 256


def start_http_server(server: BundleServer, host: str = "0.0.0.0",
                      port: int = 8000) -> ThreadingHTTPServer:
    """Bind and return the HTTP server (``port=0`` -> ephemeral; read it
    from ``.server_address[1]``). The caller runs ``serve_forever``."""
    return _HTTPServer((host, port), _make_handler(server))


def _pipeline_depth(v: str) -> int:
    n = int(v)
    if not 0 <= n <= 4:
        # fail at argparse time, not after the bundle loads
        raise argparse.ArgumentTypeError(
            f"--continuous-pipeline must be 0..4, got {n}")
    return n


def parse_args(argv=None) -> argparse.Namespace:
    e = os.environ.get
    p = argparse.ArgumentParser(
        description="Serve an exported bundle over HTTP (or stdin) on the "
                    "card")
    p.add_argument("--bundle", default=e("BUNDLE_DIR"),
                   required=e("BUNDLE_DIR") is None,
                   help="directory written by train/export.py")
    p.add_argument("--host", default=e("SERVE_HOST", "0.0.0.0"))
    p.add_argument("--port", type=int, default=int(e("SERVE_PORT", "8000")))
    p.add_argument("--continuous-slots", type=int,
                   default=int(e("CONTINUOUS_SLOTS", "0")),
                   help="KV slots of the continuous-batching engine (0 = "
                        "whole-batch serving); a paged bundle runs the "
                        "page pool, any other the dense slot cache")
    p.add_argument("--continuous-chunk", type=int,
                   default=int(e("CONTINUOUS_CHUNK", "8")),
                   help="decode steps per engine chunk between admissions")
    p.add_argument("--prefill-chunk", "--prefill-chunk-tokens",
                   dest="prefill_chunk", type=int,
                   default=int(e("PREFILL_CHUNK", "0")),
                   help="chunked prefill: admit prompts longer than this "
                        "in pieces of this many tokens, written straight "
                        "into the page pool, with decode chunks "
                        "interleaved (0 = whole-prompt prefill; 0 or >= "
                        "32; requires --continuous-slots)")
    p.add_argument("--step-token-budget", type=int,
                   default=int(e("STEP_TOKEN_BUDGET", "0")),
                   help="cap the tokens one engine step dispatches, split "
                        "between the prefill piece and the decode chunk "
                        "(live slots x steps): bounds the time between "
                        "tokens under long-prompt arrivals (0 = off; pair "
                        "with --prefill-chunk)")
    p.add_argument("--continuous-pipeline", type=_pipeline_depth,
                   default=int(e("CONTINUOUS_PIPELINE", "1")),
                   help="decode-ahead depth: keep up to N dispatched "
                        "chunks un-collected so a step's host work "
                        "overlaps the in-flight chunk (default 1, as the "
                        "JAX server; 0 = the serial loop; 0..4)")
    p.add_argument("--adaptive-chunk", action="store_true",
                   default=e("ADAPTIVE_CHUNK", "") not in ("", "0"),
                   help="budget-aligned chunking: size each dispatch to "
                        "the smallest remaining token budget over the "
                        "live slots (powers of two down to 8)")
    p.add_argument("--prefix-cache", type=int,
                   default=int(e("PREFIX_CACHE", "0")),
                   help="prefix cache: on a paged bundle the radix cache "
                        "over the KV page pool (completed prompts stay "
                        "resident as shared pages and same-prefix "
                        "admissions prefill only their suffix; the value "
                        "caps the resident pages), on a dense bundle an "
                        "LRU of that many warmed prefixes (0 = off; "
                        "requires --continuous-slots)")
    p.add_argument("--spec-tokens", type=int,
                   default=int(e("SERVE_SPEC_TOKENS", "0")),
                   help="in-engine speculative decoding: draft k tokens a "
                        "slot a round, verify all k+1 in ONE multi-query "
                        "forward (greedy token-exact; 0 = off; requires "
                        "--continuous-slots; drafts with --draft-bundle, "
                        "else the target SELF-drafts)")
    p.add_argument("--draft-bundle", default=e("DRAFT_BUNDLE_DIR", ""),
                   help="a smaller bundle of the same vocabulary: the "
                        "draft of --spec-tokens, and alone the "
                        "speculative path of single-prompt greedy "
                        "requests (identical tokens)")
    p.add_argument("--int8-kv", action="store_true",
                   default=e("SERVE_INT8_KV", "") == "1",
                   help="serve with an int8 KV cache")
    p.add_argument("--device", default=e("SERVE_DEVICE", "cuda"),
                   help="torch device ('cuda' or 'cpu')")
    p.add_argument("--schedule", choices=("fifo", "longest"),
                   default=e("CB_SCHEDULE", "fifo"),
                   help="slot admission order: fifo (arrival) or longest "
                        "(longest budget first: a shorter makespan, at "
                        "the cost of short requests' queueing)")
    p.add_argument("--max-queue-depth", type=int,
                   default=int(e("MAX_QUEUE_DEPTH", "0")),
                   help="shed (429 + Retry-After) once this many requests "
                        "wait for a slot (0 = unbounded)")
    p.add_argument("--max-queued-tokens", type=int,
                   default=int(e("MAX_QUEUED_TOKENS", "0")),
                   help="shed when the queued prompt + budget tokens would "
                        "exceed this (0 = unbounded); a request alone "
                        "above it gets 400")
    p.add_argument("--tenants", default=e("SERVE_TENANTS", ""),
                   help="tenants: JSON ('{\"light\": {\"weight\": 3}, "
                        "\"noisy\": {\"weight\": 1, \"rate\": 200}}') "
                        "or name=weight[:rate[:burst]],...; weights are "
                        "DWRR admission shares and slices of the queue "
                        "bounds, rate (tokens/s) and burst a token bucket "
                        "(429 with the tenant's own Retry-After); '*' "
                        "covers unnamed tenants; empty = tenancy off")
    p.add_argument("--drain-timeout", type=float,
                   default=float(e("DRAIN_TIMEOUT", "30")),
                   help="seconds SIGTERM waits for in-flight requests "
                        "before the server exits")
    p.add_argument("--role", choices=("mixed", "prefill", "decode"),
                   default=e("SERVE_ROLE", "mixed"),
                   help="disaggregated serving role on /loadz: the router "
                        "sends long-prompt prefills (/v1/prefill) to "
                        "'prefill' replicas and generate traffic to the "
                        "others (advisory: every role serves every "
                        "endpoint)")
    p.add_argument("--live-stall", type=float,
                   default=float(e("SERVE_LIVE_STALL", "120")),
                   help="GET /livez answers 503 once the engine's driver "
                        "loop has not finished an iteration for this many "
                        "seconds (0 = never)")
    p.add_argument("--peak-flops", type=float,
                   default=float(e("SERVE_PEAK_FLOPS", "0")),
                   help="the card's peak FLOPs/s for the serve_mfu gauge "
                        "(989e12 for an H100 in bf16); 0 = MFU off, the "
                        "CPU default")
    p.add_argument("--step-record-ring", type=int,
                   default=int(e("SERVE_STEP_RECORD_RING", "256")),
                   help="engine-step records kept for GET /stepz")
    p.add_argument("--trace-sample", type=float,
                   default=float(e("TRACE_SAMPLE", "0.01")),
                   help="fraction of requests whose traces are kept in "
                        "the /traces flight recorder (0..1); ids always "
                        "propagate (traceparent in, X-Request-Id out); 0 "
                        "with --trace-slow-ms 0 records nothing")
    p.add_argument("--trace-slow-ms", type=float,
                   default=float(e("TRACE_SLOW_MS", "1000")),
                   help="keep every trace slower than this in /traces, "
                        "sampled or not (0 = off)")
    p.add_argument("--chaos", default=e("SERVE_CHAOS", ""),
                   help="fault injection: driver-loop tokens (fail@STEP, "
                        "slow@STEP:SECONDS) and named points "
                        "(POINT:ACTION@N, POINT:ACTION%%P[:SECONDS][xK], "
                        "seed=S; points serve.request, engine.admit, "
                        "engine.device_step, bundle.load); never in "
                        "production")
    p.add_argument("--step-timeout", type=float,
                   default=float(e("SERVE_STEP_TIMEOUT", "0")),
                   help="step watchdog: an engine step running longer "
                        "than this fails every in-flight request with an "
                        "explicit error and the engine rebuilds when the "
                        "step returns (0 = off; size it well above the "
                        "first step's graph capture)")
    p.add_argument("--heartbeat-file", default=e("HEARTBEAT_FILE", ""),
                   help="node-local file the engine driver loop beats "
                        "(its age is a liveness probe's signal); "
                        "--continuous-slots only")
    p.add_argument("--metrics-textfile", default=e("METRICS_TEXTFILE", ""),
                   help="also write the metrics exposition to this .prom "
                        "file every --metrics-interval seconds (atomic "
                        "rename; a node exporter's textfile collector "
                        "reads it)")
    p.add_argument("--metrics-interval", type=float,
                   default=float(e("METRICS_INTERVAL", "15")))
    p.add_argument("--stdin", action="store_true",
                   help="serve stdin lines instead of HTTP: each input "
                        "line is a prompt, each output line a JSON result")
    p.add_argument("--max-new-tokens", type=int,
                   default=int(e("MAX_NEW_TOKENS", "64")))
    p.add_argument("--temperature", type=float,
                   default=float(e("TEMPERATURE", "0.0")))
    # the JAX server's multi-host flags: over 1 they raise (P11b)
    p.add_argument("--tp", type=int, default=int(e("SERVE_TP", "0")),
                   help="tensor-parallel ways: 0/1 only (P11b)")
    p.add_argument("--num-processes", type=int,
                   default=int(e("NUM_PROCESSES", "1")),
                   help="1 only (P11b: the multi-host serve wire)")
    p.add_argument("--process-id", type=int,
                   default=int(e("PROCESS_ID", "-1")))
    p.add_argument("--coordinator-addr", default=e("COORDINATOR_ADDR", ""))
    p.add_argument("--coordinator-port", type=int,
                   default=int(e("COORDINATOR_PORT", "8476")))
    return p.parse_args(argv)


def _resolve_bundle(path: str) -> str:
    """A bundle named by an object-store URL (``gs://``) is pulled into a
    local temporary directory first (a one-time pull; the loader reads a
    directory); a local path passes through."""
    if not is_remote(path):
        return path
    local = tempfile.mkdtemp(prefix="bundle-")
    logger.info("pulling %s -> %s", path, local)
    fs_copy_tree(path, local)
    return local


def main(argv=None) -> int:
    args = parse_args(argv)
    for flag, value in (("--tp", args.tp),
                        ("--num-processes", args.num_processes)):
        if value > 1:
            raise NotImplementedError(
                f"{flag} {value}: the multi-host serve wire is not ported "
                "to pyspark_tf_gke_tpu_torch yet (ROADMAP, queue 1, P11b)")
    server = BundleServer(_resolve_bundle(args.bundle), device=args.device,
                          continuous_slots=args.continuous_slots,
                          continuous_chunk=args.continuous_chunk,
                          int8_kv=args.int8_kv,
                          prefill_chunk=args.prefill_chunk,
                          step_token_budget=args.step_token_budget,
                          continuous_pipeline=args.continuous_pipeline,
                          adaptive_chunk=args.adaptive_chunk,
                          prefix_cache_size=args.prefix_cache,
                          spec_tokens=args.spec_tokens,
                          draft_bundle_dir=(
                              _resolve_bundle(args.draft_bundle)
                              if args.draft_bundle else args.draft_bundle),
                          schedule=args.schedule,
                          max_queue_depth=args.max_queue_depth,
                          max_queued_tokens=args.max_queued_tokens,
                          tenants_spec=args.tenants,
                          live_stall_s=args.live_stall,
                          step_record_ring=args.step_record_ring,
                          role=args.role, chaos_spec=args.chaos,
                          heartbeat_file=args.heartbeat_file,
                          trace_sample=args.trace_sample,
                          trace_slow_ms=args.trace_slow_ms,
                          step_timeout_s=args.step_timeout,
                          peak_flops=args.peak_flops,
                          # env only: a flag would show in ps and pod specs
                          admin_token=os.environ.get("SERVE_ADMIN_TOKEN",
                                                     ""))
    if args.chaos:
        logger.warning("serve-side chaos injection ACTIVE: %s", args.chaos)
    exporter = None
    if args.metrics_textfile:
        exporter = TextfileExporter(server.registry, args.metrics_textfile,
                                    args.metrics_interval).start()
    try:
        if args.stdin:
            for line in sys.stdin:
                prompt = line.rstrip("\n")
                if not prompt:
                    continue
                try:
                    out = server.generate(
                        [prompt], max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature)[0]
                except ValueError as exc:
                    # a bad line (too long, zero tokens) is that line's
                    # error, as a 400 is over HTTP
                    out = {"prompt": prompt, "error": str(exc)}
                print(json.dumps(out), flush=True)
            return 0
        httpd = start_http_server(server, args.host, args.port)
        logger.info("serving on http://%s:%d (healthz, livez, loadz, stepz, "
                    "metrics, events, traces, /v1/generate, /v1/score, "
                    "/v1/warm, /v1/prefill, /v1/kv_import, /admin/reload, "
                    "/admin/profile)", *httpd.server_address[:2])

        def drain_then_stop():
            # SIGTERM: admission stops, in-flight requests finish
            # (bounded by --drain-timeout), then the accept loop stops
            server.begin_drain()
            drained = server.drain(args.drain_timeout)
            logger.info("drain %s after SIGTERM; stopping the HTTP server",
                        "complete" if drained else
                        f"timed out at {args.drain_timeout}s")
            httpd.shutdown()

        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM,
                          lambda signum, frame: threading.Thread(
                              target=drain_then_stop, name="drain",
                              daemon=True).start())
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down")
        finally:
            httpd.server_close()
        return 0
    finally:
        if exporter is not None:
            exporter.stop()  # the final write has the shutdown state
        server.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
