"""Named fault points + seed-deterministic injectors (the counterpart
of ``pyspark_tf_gke_tpu/chaos/inject.py``).

* :class:`FaultInjector` — the step-loop injector the serving driver
  loop runs (``--chaos`` ``fail@N`` / ``slow@N:S`` tokens): fail or
  slow at chosen busy steps, each fired once.
* :class:`ChaosInjector` — rules bound to NAMED fault points
  (:data:`FAULT_POINTS`). Rules fire by per-point invocation count
  (``point:fail@N``) or by seeded probability (``point:fail%P``: a
  private splitmix64 stream keyed on ``(seed, point, rule index)``, the
  JAX package's, so a seed fires the same invocations in both
  packages).

Instrumented sites call :func:`chaos_fire` — one module-global ``None``
check when no injector is installed. Every fired fault lands on the
event trail (``fault_injected``) and in
``fault_injections_total{point,action}``. The catalog keeps the JAX
package's points; this package wires ``serve.request``,
``engine.device_step``, ``engine.admit`` and ``bundle.load``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional

# -- the fault-point catalog (docs/CHAOS.md mirrors this) ---------------------
#
# A rule naming a point not listed here is a spec error (fail fast at
# parse time — a typo'd point would otherwise silently never fire and
# the scenario would "pass" having injected nothing).
FAULT_POINTS: Dict[str, str] = {
    # router data plane: one forwarded POST raises ReplicaUnreachable
    # before the status line — the passive-health + single-failover
    # path (a scheduled stand-in for a pod dying mid-connect)
    "router.transport": "forwarded replica request transport failure",
    # router control plane: one /loadz probe raises — the health-flap /
    # probe-partition shape (the replica is fine; the prober can't see
    # it, so fail-threshold and re-admission logic must carry it)
    "router.probe": "health-probe transport failure (probe partition)",
    # BundleServer HTTP front: the request handler raises after the
    # body parse — the 500-with-terminal path, counted, never a hang
    "serve.request": "BundleServer request-front failure",
    # engine device plane: raise (failed device step -> engine rebuild)
    # or sleep (hung device step -> the step watchdog's case) inside
    # the decode-chunk dispatch, while the driver loop holds its lock
    "engine.device_step": "failed/hung device decode-chunk dispatch",
    # engine admission: raise after the page allocation, before the
    # prefill lands — the refcount-discipline crash path (held pages
    # must return to the pool; the request must stay queued or fail
    # with a terminal, never leak)
    "engine.admit": "admission failure after page allocation",
    # checkpoint IO: raise inside the retried save/restore closures so
    # the injection exercises retry_with_backoff, not a bare raise
    "checkpoint.save": "checkpoint save IO failure (inside the retry)",
    "checkpoint.restore": "checkpoint restore IO failure (inside the retry)",
    # serving-bundle load (boot + hot-swap reload, same retried path)
    "bundle.load": "serving-bundle load failure (inside the retry)",
    # pipeline publish: one POST /admin/reload raises — the rollout
    # must stop (untouched replicas keep serving) and the coordinator
    # must resume the publish stage on its next round entry
    "pipeline.publish": "replica publish (POST /admin/reload) failure",
    # autopilot actuation: one scale-up/scale-down application raises
    # before the action takes effect — the decision must retry with
    # backoff and apply EXACTLY once (never double-started, never
    # double-drained), which the autopilot tests assert in closed form
    "autopilot.actuate": "autopilot scale actuation failure",
}

_ACTIONS = ("fail", "slow", "hang")


class InjectedFault(RuntimeError):
    """Raised by the injectors — distinguishable from real faults."""


def splitmix64_stream(key: str):
    """Deterministic uint64 stream derived from a string ``key``
    (FNV-1a seed + splitmix64 advance): the JAX package's replay/chaos
    mixer (``replay/spec.py``), bit for bit, so one seed fires the same
    invocations in both packages."""
    h = 1469598103934665603
    for c in key.encode():
        h = ((h ^ c) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    x = h or 1
    while True:
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        yield z ^ (z >> 31)


def seeded_unit_stream(key: str):
    """U[0,1) floats over :func:`splitmix64_stream` (53-bit draws)."""
    for z in splitmix64_stream(key):
        yield (z >> 11) / float(1 << 53)


def _rule_stream(seed: int, point: str, index: int):
    """Deterministic U[0,1) stream for one probabilistic rule, keyed on
    (seed, point, rule index): NOTHING environmental (hash
    randomization, process ids, wall clock) can change which
    invocations fire."""
    return seeded_unit_stream(f"{seed}:{point}:{index}")


class _Rule:
    """One parsed injection rule bound to a fault point."""

    __slots__ = ("point", "action", "at", "prob", "seconds", "max_fires",
                 "fires", "_stream")

    def __init__(self, point: str, action: str, *, at: Optional[int] = None,
                 prob: Optional[float] = None, seconds: float = 0.0,
                 max_fires: Optional[int] = None, seed: int = 0,
                 index: int = 0):
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: "
                f"{', '.join(sorted(FAULT_POINTS))})")
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown action {action!r} (known: {_ACTIONS})")
        if (at is None) == (prob is None):
            raise ValueError(
                f"rule on {point!r} needs exactly one of @N / %P")
        if at is not None and at < 1:
            raise ValueError(f"rule on {point!r}: @N is 1-based")
        if prob is not None and not 0.0 < prob <= 1.0:
            raise ValueError(
                f"rule on {point!r}: %P must be in (0, 1], got {prob}")
        if action in ("slow", "hang") and seconds <= 0:
            raise ValueError(
                f"rule on {point!r}: {action} takes :SECONDS > 0")
        self.point = point
        self.action = action
        self.at = at
        self.prob = prob
        self.seconds = float(seconds)
        # count-based rules fire ONCE (the train injector's fired-once
        # contract: a post-recovery replay of the same step must not
        # immediately re-fail); probabilistic rules default unbounded
        self.max_fires = (max_fires if max_fires is not None
                          else (1 if at is not None else None))
        self.fires = 0
        self._stream = (_rule_stream(seed, point, index)
                        if prob is not None else None)

    def should_fire(self, invocation: int) -> bool:
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at is not None:
            return invocation == self.at
        # probabilistic: ONE draw per invocation, consumed whether or
        # not it fires, so the fired set depends only on (seed, point,
        # rule index, invocation number)
        return next(self._stream) < self.prob

    def describe(self) -> str:
        when = (f"@{self.at}" if self.at is not None
                else f"%{self.prob:g}")
        dur = f":{self.seconds:g}" if self.seconds else ""
        cap = (f"x{self.max_fires}"
               if self.max_fires is not None and self.at is None else "")
        return f"{self.point}:{self.action}{when}{dur}{cap}"


class ChaosInjector:
    """Seed-deterministic injector over named fault points.

    Spec grammar (comma-separated tokens)::

        POINT:ACTION@N[:SECONDS]        fire at the Nth hit of POINT (once)
        POINT:ACTION%P[:SECONDS][xK]    fire each hit w.p. P (seeded; at
                                        most K times when xK is given)
        seed=S                          seed for the %P streams

    Actions: ``fail`` raises (:class:`InjectedFault`, or the exception
    type the call site maps it to — e.g. the router maps to
    ``ReplicaUnreachable`` so the REAL handling path runs), ``slow``
    and ``hang`` sleep SECONDS (two spellings of one mechanic; ``hang``
    documents intent — it is the shape a step watchdog must reap).

    Thread-safe: fired from HTTP handler threads, the prober and the
    engine driver concurrently; per-point invocation counters and rule
    state live behind one lock (the sleep itself runs outside it).
    """

    def __init__(self, rules: Iterable[_Rule], seed: int = 0):
        self.rules: List[_Rule] = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._invocations: Dict[str, int] = {}
        # (point, action, invocation) of every fired rule — the
        # post-run accounting a chaos scenario asserts on
        self.fired: List[dict] = []

    @classmethod
    def from_spec(cls, spec: str) -> Optional["ChaosInjector"]:
        """Parse the spec grammar; empty → None (no injection)."""
        tokens = [t.strip() for t in str(spec).split(",") if t.strip()]
        seed = 0
        raw: List[str] = []
        for tok in tokens:
            if tok.startswith("seed="):
                seed = int(tok[len("seed="):])
            else:
                raw.append(tok)
        rules: List[_Rule] = []
        for i, tok in enumerate(raw):
            point, sep, rest = tok.partition(":")
            if not sep or not point or not rest:
                raise ValueError(
                    f"chaos token {tok!r}: want POINT:ACTION@N or "
                    f"POINT:ACTION%P (see FAULT_POINTS)")
            action = rest
            at = prob = None
            seconds = 0.0
            max_fires = None
            if "@" in rest:
                action, _, where = rest.partition("@")
                where, _, dur = where.partition(":")
                at = int(where)
                seconds = float(dur) if dur else 0.0
            elif "%" in rest:
                action, _, p = rest.partition("%")
                if "x" in p:
                    p, _, cap = p.rpartition("x")
                    max_fires = int(cap)
                p, _, dur = p.partition(":")
                prob = float(p)
                seconds = float(dur) if dur else 0.0
            else:
                raise ValueError(
                    f"chaos token {tok!r}: ACTION needs @N or %P")
            rules.append(_Rule(point, action, at=at, prob=prob,
                               seconds=seconds, max_fires=max_fires,
                               seed=seed, index=i))
        if not rules:
            return None
        return cls(rules, seed=seed)

    def describe(self) -> str:
        out = ",".join(r.describe() for r in self.rules)
        return f"seed={self.seed},{out}" if self.seed else out

    def fired_count(self, point: Optional[str] = None) -> int:
        with self._lock:
            if point is None:
                return len(self.fired)
            return sum(1 for f in self.fired if f["point"] == point)

    def fire(self, point: str, exc: Optional[type] = None, **ctx):
        """One hit of ``point``: advance its invocation counter, fire
        any due rules. A ``fail`` rule raises ``exc`` (default
        :class:`InjectedFault`) AFTER any due slow/hang sleeps run —
        scheduled latency composes with scheduled failure. Returns the
        injected sleep seconds (0.0 when nothing slowed)."""
        due: List[_Rule] = []
        with self._lock:
            n = self._invocations.get(point, 0) + 1
            self._invocations[point] = n
            for rule in self.rules:
                if rule.point == point and rule.should_fire(n):
                    rule.fires += 1
                    due.append(rule)
            for rule in due:
                self.fired.append({"point": point, "action": rule.action,
                                   "invocation": n,
                                   "seconds": rule.seconds, **ctx})
        if not due:
            return 0.0
        slept = 0.0
        failing: Optional[_Rule] = None
        for rule in due:
            self._note(point, rule.action, n, rule.seconds, ctx)
            if rule.action == "fail":
                failing = rule
            else:
                time.sleep(rule.seconds)
                slept += rule.seconds
        if failing is not None:
            exc_type = exc if exc is not None else InjectedFault
            raise exc_type(
                f"injected fault at {point} (invocation {n})")
        return slept

    @staticmethod
    def _note(point: str, action: str, invocation: int, seconds: float,
              ctx: dict) -> None:
        """Trail event + counter for one fired rule. Lazy obs import:
        this module is on the router/client hot path and must stay
        import-cheap; a broken obs plane must never mask the fault."""
        try:
            from pyspark_tf_gke_tpu_torch.obs.events import get_event_log
            from pyspark_tf_gke_tpu_torch.obs.metrics import chaos_families

            chaos_families()["fault_injections_total"].labels(
                point=point, action=action).inc()
            get_event_log().emit(
                "fault_injected", point=point, action=action,
                invocation=invocation,
                **({"seconds": seconds} if seconds else {}),
                **{k: str(v)[:120] for k, v in ctx.items()})
        except Exception:  # noqa: BLE001 — observability of the chaos
            pass           # must never change what the chaos does


# -- process-global install ---------------------------------------------------
#
# One injector per process (a replica, a router, a coordinator each get
# their own via --chaos / SERVE_CHAOS / ROUTER_CHAOS). Module-global so
# instrumented sites pay a single attribute load when chaos is off —
# which is every production process, always.

_INJECTOR: Optional[ChaosInjector] = None


def install(injector: Optional[ChaosInjector]) -> Optional[ChaosInjector]:
    """Install ``injector`` as the process's fault source (None clears
    it). Returns the previous injector so tests can restore it."""
    global _INJECTOR
    prev = _INJECTOR
    _INJECTOR = injector
    return prev


def uninstall() -> None:
    install(None)


def get_injector() -> Optional[ChaosInjector]:
    return _INJECTOR


def chaos_fire(point: str, exc: Optional[type] = None, **ctx):
    """THE instrumented-site entry: no-op (one None check) without an
    installed injector; otherwise one hit of ``point``."""
    if _INJECTOR is None:
        return 0.0
    return _INJECTOR.fire(point, exc=exc, **ctx)


# -- the lifted train-plane injector ------------------------------------------


class FaultInjector:
    """Deterministic chaos for a STEP LOOP: raise :class:`InjectedFault`
    when the loop reaches any of ``fail_at_steps`` — once per step
    value, so the post-recovery pass (which replays the same global
    step after resume) does not immediately re-fail. ``slow_at_steps``
    (step → seconds) injects SLOW steps instead of failures — the
    wedged-device shape a liveness probe must catch — each fired once
    as well.

    Lifted from ``train/resilience.py`` (which re-exports it): the
    trainer's recovery loop and the serving driver loop (``--chaos``
    ``fail@N``/``slow@N:S`` tokens) both ride this; the named-point
    :class:`ChaosInjector` generalizes the same mechanics to the rest
    of the system."""

    def __init__(self, fail_at_steps: Iterable[int] = (),
                 slow_at_steps: Optional[Mapping[int, float]] = None):
        self.pending = set(int(s) for s in fail_at_steps)
        self.slow_pending: Dict[int, float] = {
            int(k): float(v) for k, v in (slow_at_steps or {}).items()}
        # the injection plan, for post-run accounting (a chaos soak
        # asserts rebuilds == faults that actually fired)
        self.n_faults = len(self.pending)
        self.n_slow = len(self.slow_pending)

    @classmethod
    def from_spec(cls, spec: str) -> Optional["FaultInjector"]:
        """Parse a "12,40" CLI/env spec; empty → None (no injection)."""
        steps = [int(s) for s in spec.split(",") if s.strip()]
        return cls(steps) if steps else None

    @classmethod
    def from_chaos_spec(cls, spec: str) -> Optional["FaultInjector"]:
        """Parse the serve-side chaos spec: comma-separated tokens
        ``fail@STEP`` (raise at driver step STEP) and
        ``slow@STEP:SECONDS`` (sleep SECONDS at that step); a bare
        integer is a failure (the training spec's shorthand). Empty →
        None (no injection). ``SERVE_CHAOS="fail@10,slow@25:0.5"``
        fails the 10th busy driver iteration and wedges the 25th.
        (Named-point tokens — anything with a ``.`` before the first
        ``:`` — belong to :meth:`ChaosInjector.from_spec`; the serve
        CLI splits the two grammars.)"""
        fails, slows = [], {}
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if tok.startswith("slow@"):
                where, _, dur = tok[len("slow@"):].partition(":")
                if not where or not dur:
                    raise ValueError(
                        f"chaos token {tok!r}: slow takes "
                        f"slow@STEP:SECONDS")
                slows[int(where)] = float(dur)
            elif tok.startswith("fail@"):
                fails.append(int(tok[len("fail@"):]))
            else:
                fails.append(int(tok))
        if not fails and not slows:
            return None
        return cls(fails, slows)

    @property
    def fired_faults(self) -> int:
        """Failures injected so far (plan minus still-pending)."""
        return self.n_faults - len(self.pending)

    def maybe_fail(self, step: int) -> None:
        if int(step) in self.pending:
            self.pending.discard(int(step))
            from pyspark_tf_gke_tpu_torch.obs.events import get_event_log

            # preemption-simulation evidence rides the shared trail: a
            # chaos run's injected faults and its retries correlate by seq
            get_event_log().emit("fault_injected", step=int(step))
            raise InjectedFault(f"injected fault at step {step}")

    def maybe_slow(self, step: int) -> float:
        """Sleep (once) if ``step`` is a planned slow step; returns the
        injected delay in seconds (0.0 when none fired)."""
        dur = self.slow_pending.pop(int(step), None)
        if not dur:
            return 0.0
        from pyspark_tf_gke_tpu_torch.obs.events import get_event_log

        get_event_log().emit("slow_step_injected", step=int(step),
                             seconds=float(dur))
        time.sleep(dur)
        return float(dur)


def split_serve_chaos_spec(spec: str):
    """Split one ``--chaos`` value into its two grammars: legacy
    driver-loop tokens (``fail@N`` / ``slow@N:S`` / bare ints →
    :class:`FaultInjector`) and named-point tokens (``POINT:ACTION...``
    where POINT contains a ``.`` → :class:`ChaosInjector`). Returns
    ``(fault_injector_or_None, chaos_injector_or_None)``."""
    legacy, named = [], []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        head = tok.partition(":")[0]
        if "." in head or tok.startswith("seed="):
            named.append(tok)
        else:
            legacy.append(tok)
    return (FaultInjector.from_chaos_spec(",".join(legacy))
            if legacy else None,
            ChaosInjector.from_spec(",".join(named)) if named else None)
