"""Engine step telemetry (counterpart of
``pyspark_tf_gke_tpu/obs/stepstats.py``): phase-level step
decomposition with the same keys and the same measurement model.

* :class:`StepRecord` — one engine step's timing and batch composition:
  per-phase wall time (the :data:`PHASES` vocabulary), decode slots,
  prefill pieces/tokens, speculative rounds, tokens delivered, queue
  depth at entry, and a terminal ``outcome`` (``ok | error | reaped``).
  Phase attribution is EXCLUSIVE: a nested ``phase()`` context pauses
  its parent, so the phase sums reconcile with the step wall.
* :class:`StepStatsRing` — a thread-safe bounded ring of the last N
  closed records. A record enters the ring exactly ONCE, at
  :meth:`StepStatsRing.close`; a record abandoned mid-step never lands.

Measurement model: the engine notes one DEVICE-BUSY INTERVAL per
dispatched chunk, ``[dispatch timestamp, retire timestamp]``, where
retire is the moment the chunk's completion event was OBSERVED (a
non-blocking ``event.query()`` at the top and tail of each step, or the
fetch return for a chunk that was still computing when its data was
needed). ``host_overhead_frac`` / ``device_idle_fraction`` is ``1 -
union(busy intervals) / window span`` — the fraction of the windowed
wall-clock span with no chunk in flight on the device. On the serial
loop this agrees with ``sum(wall - device_wait) / sum(wall)``, which is
kept as ``host_work_frac`` (a cost number once the pipeline overlaps
host work with compute). Retire is observed at poll boundaries, so busy
rounds UP and idle is a floor. A ring never fed intervals falls back to
the historical formula for both numbers.

The port has no metrics registry yet: :meth:`StepStatsRing.bind` takes
``obs=None`` (observe nothing) or a dict of handles with the JAX
package's names. Stdlib-only.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# The phase vocabulary:
#   expire      — deadline sweep (queued + in-slot expiry)
#   schedule    — admission work: DWRR/FIFO picks, prefill pieces,
#                 batched admits, page allocation (prefill FORWARDS are
#                 dispatched async here; their device time is paid at
#                 the collect's device_wait)
#   dispatch    — decode-chunk dispatch (host-side trace/submit; the
#                 announce-mode unpipelined path blocks here, which the
#                 nested device_wait context carves out)
#   device_wait — host blocked on a device→host fetch (the one sync
#                 point of the serial loop)
#   collect     — host bookkeeping over fetched tokens: eos/budget
#                 completion, streaming callbacks, frees, trie adoption
#   deliver     — waiter wakeups + quota settlement (the serving
#                 front's _deliver_finished; amended onto the record by
#                 the engine thread right after the step closes)
PHASES = ("expire", "schedule", "dispatch", "device_wait", "collect",
          "deliver")

_OUTCOMES = ("ok", "error", "reaped")


def flops_per_token(cfg, context_len: Optional[int] = None) -> float:
    """Decode FLOPs per generated token estimated from a
    ``CausalLMConfig``-shaped object (attribute access only — no jax,
    no import of the models package). The standard serving estimate:
    ``2 × matmul params`` (every weight read is one MAC per token)
    plus ``4 × layers × context × hidden`` for attention's QK^T + AV
    against the KV cache, with K/V projections scaled down by GQA.
    ``context_len`` defaults to half the model's max_seq_len (a mid-
    generation average). Returns 0.0 when the config doesn't carry the
    expected fields — the MFU gauge then stays disabled."""
    try:
        h = int(cfg.hidden_size)
        layers = int(cfg.num_layers)
        vocab = int(cfg.vocab_size)
        inter = int(cfg.intermediate_size)
        heads = int(cfg.num_heads)
        kv_heads = int(getattr(cfg, "num_kv_heads", None) or heads)
        ctx = int(context_len if context_len is not None
                  else max(int(cfg.max_seq_len) // 2, 1))
    except (AttributeError, TypeError, ValueError):
        return 0.0
    attn_proj = (2.0 + 2.0 * kv_heads / max(heads, 1)) * h * h
    ffn_mats = 3 if getattr(cfg, "ffn", "gelu") == "swiglu" else 2
    matmul_params = layers * (attn_proj + ffn_mats * h * inter) + vocab * h
    return 2.0 * matmul_params + 4.0 * layers * ctx * h


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (0.0 when empty), rounded to 3 places —
    the rule of ``pyspark_tf_gke_tpu/replay/stats.py`` ``pct``."""
    if not sorted_vals:
        return 0.0
    xs = sorted(sorted_vals)
    return round(xs[min(len(xs) - 1, int(q * (len(xs) - 1)))], 3)


class StepRecord:
    """One engine step's telemetry. Built by
    :meth:`StepStatsRing.begin`, phases timed via the nesting-aware
    :meth:`phase` context (exclusive attribution: entering a child
    pauses the parent, so ``sum(phases) <= wall`` and reconciles with
    it up to untimed gaps), closed exactly once by
    :meth:`StepStatsRing.close`."""

    __slots__ = ("seq", "t_start", "wall_ms", "phases", "decode_slots",
                 "prefill_pieces", "prefill_tokens", "spec_rounds",
                 "tokens_out", "queue_depth", "expired", "outcome",
                 "closed", "_stack", "_clock", "device_busy_ms")

    def __init__(self, seq: int, clock=time.monotonic,
                 queue_depth: int = 0):
        self.seq = int(seq)
        self._clock = clock
        self.t_start = clock()
        self.wall_ms = 0.0
        self.phases: Dict[str, float] = {}
        self.decode_slots = 0
        self.prefill_pieces = 0
        self.prefill_tokens = 0
        self.spec_rounds = 0
        self.tokens_out = 0
        self.queue_depth = int(queue_depth)
        self.expired = 0
        self.outcome = "ok"
        self.closed = False
        # device-busy milliseconds of the chunk(s) SETTLED during this
        # step (dispatch->retire span, summed) — the per-row /stepz
        # view of the windowed interval derivation; 0.0 until a settle
        # stamps it
        self.device_busy_ms = 0.0
        self._stack: List[list] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a phase. Nesting pauses the enclosing phase: the
        elapsed span is attributed to exactly one phase at any
        instant, which is what makes the phase-sum-vs-wall invariant
        checkable."""
        now = self._clock()
        if self._stack:
            top = self._stack[-1]
            self.phases[top[0]] = (self.phases.get(top[0], 0.0)
                                   + (now - top[1]) * 1000.0)
        self._stack.append([name, now])
        try:
            yield
        finally:
            now = self._clock()
            top = self._stack.pop()
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + (now - top[1]) * 1000.0)
            if self._stack:
                self._stack[-1][1] = now  # parent resumes from here

    @property
    def device_wait_ms(self) -> float:
        return self.phases.get("device_wait", 0.0)

    @property
    def host_overhead_ms(self) -> float:
        """Step wall minus device-wait: every millisecond of Python
        bookkeeping the device spent idle for (on the serial loop)."""
        return max(0.0, self.wall_ms - self.device_wait_ms)

    @property
    def activity(self) -> bool:
        """Did this step do any work worth a record? Idle spins
        (empty queue, no slots) are discarded instead of flooding the
        ring with zero rows."""
        return bool(self.decode_slots or self.prefill_pieces
                    or self.prefill_tokens or self.tokens_out
                    or self.expired or self.outcome != "ok")

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "wall_ms": round(self.wall_ms, 3),
            "host_overhead_ms": round(self.host_overhead_ms, 3),
            "device_busy_ms": round(self.device_busy_ms, 3),
            "phases_ms": {k: round(v, 3)
                          for k, v in sorted(self.phases.items())},
            "decode_slots": self.decode_slots,
            "prefill_pieces": self.prefill_pieces,
            "prefill_tokens": self.prefill_tokens,
            "spec_rounds": self.spec_rounds,
            "tokens_out": self.tokens_out,
            "queue_depth": self.queue_depth,
            "expired": self.expired,
            "outcome": self.outcome,
        }


class StepStatsRing:
    """Thread-safe bounded ring of closed :class:`StepRecord`\\ s.

    Lifecycle contract (the exactly-once invariant the chaos suite
    pins): ``begin()`` hands out a record that is NOT in the ring;
    ``close()`` appends it exactly once (idempotent — a second close
    is a no-op returning False); ``mark_reaped()`` amends the outcome
    of the already-closed record in place (the watchdog path: the
    stuck step returned, its record closed normally, the front
    relabels it); a record never closed (step still hung) never
    enters the ring. ``add_deliver()`` amends the front's delivery
    time onto the just-closed record — wall and the ``deliver`` phase
    grow together, so the phase-sum invariant survives the amend.

    One engine (or a serving front across engine REBUILDS — the front
    owns the ring and threads it through every engine it builds, so
    ``/stepz`` history survives a rebuild) writes; any thread reads
    via :meth:`snapshot`/:meth:`summary`."""

    def __init__(self, capacity: int = 256, window: int = 64,
                 clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.window = max(1, int(window))
        self._clock = clock
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._last: Optional[StepRecord] = None
        self._obs = None
        self.flops_per_token = 0.0
        self.peak_flops = 0.0
        # device-busy intervals [(t_dispatch, t_retire), ...] in clock
        # seconds, noted by the engine per dispatched chunk (see the
        # module docstring's measurement model). Sized past the record
        # window so every windowed step's chunk(s) are still held even
        # with spec rounds dispatching several chunks per step.
        self._intervals = deque(maxlen=4 * self.window)

    def bind(self, obs=None, flops_per_token: float = 0.0,
             peak_flops: float = 0.0) -> "StepStatsRing":
        """Attach metric handles (a ``platform_families`` dict) and
        the MFU inputs; re-binding (engine rebuild) is fine — last
        bind wins. The windowed gauges (``serve_device_idle_fraction``,
        ``serve_mfu``) read this ring when scraped, so a step pays only
        its histogram observations."""
        self._obs = obs
        self.flops_per_token = float(flops_per_token or 0.0)
        self.peak_flops = float(peak_flops or 0.0)
        if obs is not None:
            g = obs.get("serve_device_idle_fraction")
            if g is not None:
                g.set_function(lambda: round(self.host_overhead_frac(), 4))
            g = obs.get("serve_mfu")
            if g is not None:
                g.set_function(lambda: round(self._windowed(self._mfu_locked),
                                             6))
        return self

    def _windowed(self, fn) -> float:
        with self._lock:
            return fn()

    @property
    def next_seq(self) -> int:
        """Seq the next :meth:`begin` will assign (the profiler's
        capture-window start marker)."""
        with self._lock:
            return self._seq

    @property
    def last_record(self) -> Optional[StepRecord]:
        """Most recently CLOSED record (None before the first)."""
        with self._lock:
            return self._last

    def begin(self, queue_depth: int = 0) -> StepRecord:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return StepRecord(seq, clock=self._clock,
                          queue_depth=queue_depth)

    def close(self, rec: StepRecord, outcome: Optional[str] = None
              ) -> bool:
        """Close + ring-append exactly once. Returns False (no-op) on
        a second close of the same record."""
        with self._lock:
            if rec.closed:
                return False
            rec.closed = True
            rec.wall_ms = (self._clock() - rec.t_start) * 1000.0
            if outcome is not None:
                if outcome not in _OUTCOMES:
                    raise ValueError(f"unknown outcome {outcome!r}")
                rec.outcome = outcome
            self._ring.append(rec)
            self._last = rec
            self._observe_locked(rec)
        return True

    def add_deliver(self, rec: StepRecord, ms: float) -> None:
        """Amend the front's delivery time onto a closed record (the
        one phase that runs OUTSIDE ``engine.step()``). Wall grows by
        the same amount, so phase sums still reconcile."""
        ms = max(0.0, float(ms))
        with self._lock:
            if not rec.closed:
                return
            rec.phases["deliver"] = rec.phases.get("deliver", 0.0) + ms
            rec.wall_ms += ms
            if self._obs is not None:
                h = self._obs.get("serve_step_phase_ms")
                if h is not None:
                    h.labels(phase="deliver").observe(ms)

    def note_device_interval(self, t0: float, t1: float) -> None:
        """Record one device-busy interval: ``t0`` = chunk dispatch
        timestamp, ``t1`` = the moment its results were OBSERVED ready
        (an ``is_ready`` poll at the next step's top, or the fetch
        return when the data was needed first). Clock domain must match
        the ring's ``clock``. Feeding intervals is what switches
        :meth:`host_overhead_frac` from the legacy serial-loop formula
        to the true interval-union device-idle derivation."""
        t0 = float(t0)
        t1 = float(t1)
        if t1 < t0:
            t0, t1 = t1, t0
        with self._lock:
            self._intervals.append((t0, t1))

    def mark_reaped(self, rec: StepRecord) -> None:
        """The watchdog reaped this step's waiters while it hung:
        relabel its (already-closed) record. Amends in place — the
        record was appended once at close and stays appended once."""
        with self._lock:
            rec.outcome = "reaped"

    def discard(self, rec: StepRecord) -> None:
        """Drop a record that never earned a ring slot (idle step).
        Nothing to undo — begin() never inserted it."""

    # -- read side --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self, n: int = 64, min_ms: Optional[float] = None
                 ) -> List[dict]:
        """Newest-first dicts of the last ``n`` records, optionally
        only those with ``wall_ms >= min_ms`` (the /stepz ``?n=`` /
        ``?min_ms=`` filters). Serialized UNDER the lock: the engine
        thread's ``add_deliver`` inserts into a record's phases dict,
        and iterating it concurrently would raise mid-scrape."""
        with self._lock:
            recs = list(self._ring)
            recs.reverse()
            if min_ms is not None:
                recs = [r for r in recs if r.wall_ms >= float(min_ms)]
            return [r.to_dict() for r in recs[:max(1, int(n))]]

    def host_overhead_frac(self) -> float:
        """Windowed device-idle fraction — what ``/loadz
        step_host_overhead_frac`` advertises and the router folds into
        its autoscale block. Interval-derived when the engine has fed
        dispatch/retire timestamps (``1 - union(busy)/span`` — see the
        module docstring); falls back to the legacy serial-loop
        formula ``sum(wall - device_wait)/sum(wall)`` for rings never
        fed intervals (0.0 when empty either way)."""
        with self._lock:
            return self._host_overhead_frac_locked()

    def _host_overhead_frac_locked(self) -> float:
        idle = self._device_idle_frac_locked()
        if idle is not None:
            return idle
        return self._host_work_frac_locked()

    def _host_work_frac_locked(self) -> float:
        """The historical formula: the host-work share of step wall.
        On the serial loop this IS device idle; on the pipelined loop
        it is a cost number only (host work overlapped by an in-flight
        chunk no longer idles the device)."""
        recs = list(self._ring)[-self.window:]
        wall = sum(r.wall_ms for r in recs)
        if wall <= 0.0:
            return 0.0
        host = sum(r.host_overhead_ms for r in recs)
        return min(1.0, max(0.0, host / wall))

    def _device_idle_frac_locked(self) -> Optional[float]:
        """True device-idle fraction over the windowed span:
        ``1 - union(device-busy intervals) / span``, intervals clipped
        to the window. None when no interval overlaps the window (the
        caller falls back to the legacy formula)."""
        recs = list(self._ring)[-self.window:]
        if not recs:
            return None
        lo = recs[0].t_start
        hi = recs[-1].t_start + recs[-1].wall_ms / 1000.0
        span = hi - lo
        if span <= 0.0:
            return None
        clipped = []
        for (a, b) in self._intervals:
            a = max(a, lo)
            b = min(b, hi)
            if b > a:
                clipped.append((a, b))
        if not clipped:
            return None
        clipped.sort()
        busy = 0.0
        cur_a, cur_b = clipped[0]
        for a, b in clipped[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        return min(1.0, max(0.0, 1.0 - busy / span))

    @staticmethod
    def _span_s(recs: List[StepRecord]) -> float:
        """Wall-clock span covered by a window of records: first
        step's start to last step's end. Unlike the sum of busy-step
        walls it INCLUDES idle gaps between steps, so throughput-like
        derivations (tokens/sec, MFU) report real utilization, not
        per-busy-step throughput — a replica serving one request a
        second must not read as saturated. Floored at the busy-wall
        sum (amends and clock quirks can't shrink it below the work
        actually timed)."""
        if not recs:
            return 0.0
        busy_s = sum(r.wall_ms for r in recs) / 1000.0
        span = (recs[-1].t_start + recs[-1].wall_ms / 1000.0
                - recs[0].t_start)
        return max(span, busy_s)

    def _mfu_locked(self) -> float:
        if self.peak_flops <= 0.0 or self.flops_per_token <= 0.0:
            return 0.0
        recs = list(self._ring)[-self.window:]
        span_s = self._span_s(recs)
        if span_s <= 0.0:
            return 0.0
        tokens = sum(r.tokens_out + r.prefill_tokens for r in recs)
        return tokens / span_s * self.flops_per_token / self.peak_flops

    def summary(self) -> dict:
        """Windowed aggregate: record count, host-overhead fraction,
        per-phase p50/p99, wall p50/p99, tokens/sec and MFU — the
        ``step_phases`` block ``engine.stats`` (and therefore the cb
        bench trail) carries."""
        with self._lock:
            recs = list(self._ring)[-self.window:]
            frac = self._host_overhead_frac_locked()
            work = self._host_work_frac_locked()
            mfu = self._mfu_locked()
        if not recs:
            return {"records": 0, "host_overhead_frac": 0.0,
                    "host_work_frac": 0.0,
                    "device_idle_fraction": 0.0, "mfu": 0.0,
                    "wall_ms": {}, "phase_ms": {}}
        walls = sorted(r.wall_ms for r in recs)
        phase_ms = {}
        for name in PHASES:
            vals = sorted(r.phases[name] for r in recs
                          if name in r.phases)
            if vals:
                phase_ms[name] = {"p50": round(_percentile(vals, 0.5), 3),
                                  "p99": round(_percentile(vals, 0.99), 3)}
        span_s = self._span_s(recs)
        tokens = sum(r.tokens_out + r.prefill_tokens for r in recs)
        return {
            "records": len(recs),
            # interval-derived device idle when the engine feeds
            # dispatch/retire timestamps; the legacy formula otherwise
            # (see the module docstring's measurement model)
            "host_overhead_frac": round(frac, 4),
            # the historical sum(wall - device_wait)/sum(wall) — equal
            # to host_overhead_frac on the serial loop, strictly above
            # it once the pipeline overlaps host work with compute
            "host_work_frac": round(work, 4),
            "device_idle_fraction": round(frac, 4),
            "mfu": round(mfu, 6),
            # span-based (start of first windowed step -> end of the
            # last, idle gaps included): real windowed throughput
            "tokens_per_sec": (round(tokens / span_s, 1)
                               if span_s else 0.0),
            "wall_ms": {"p50": round(_percentile(walls, 0.5), 3),
                        "p99": round(_percentile(walls, 0.99), 3)},
            "phase_ms": phase_ms,
        }

    # -- metrics ----------------------------------------------------------

    def _observe_locked(self, rec: StepRecord) -> None:
        obs = self._obs
        if obs is None:
            return
        h = obs.get("serve_step_host_overhead_ms")
        if h is not None:
            h.observe(rec.host_overhead_ms)
        h = obs.get("serve_step_phase_ms")
        if h is not None:
            for name, ms in rec.phases.items():
                h.labels(phase=name).observe(ms)
