"""PyTorch port, tenancy: the serving front's tenant spec, token buckets
and the engine's deficit-weighted round robin, each held against the
JAX package's on the same inputs — ``parse_tenant_spec``,
``TokenBucket`` and ``DwrrScheduler`` call for call; the port's engine
admits in the JAX engine's order (two and three tenants, the ``*``
weight, ``schedule="longest"``, single-tenant FIFO) and gives its
tokens; the port's front sheds, refunds and resolves tenants as the JAX
front does (``tests/test_fairness.py``'s front cases, both fronts on
one paged f32 model).
"""

import itertools
import time

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.train import continuous as jcont
from pyspark_tf_gke_tpu.train import serve as jserve
from pyspark_tf_gke_tpu_torch.train import continuous as tcont
from pyspark_tf_gke_tpu_torch.train import serve as tserve
from tests.test_torch_engine import _models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm():
    return _models(num_pages=32)


# -- the tenant spec and the token bucket ---------------------------------------

SPECS = ["light=3,noisy=1:200:400", "a=1:10,b=2::50, c=0.5",
         '{"light": {"weight": 3}, "noisy": {"weight": 1, "rate": 200}, '
         '"*": 2}', {"vip": {"weight": 4, "burst": 9}, "*": 1}, "", None]
BAD_SPECS = ["light", "light=0", '{"a": {"wieght": 1}}', "a=1:2:3:4",
             "a=1:-5", "[1, 2]"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenant_spec_matches_jax(spec):
    assert tserve.parse_tenant_spec(spec) == jserve.parse_tenant_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_tenant_spec_rejects_as_jax(spec):
    with pytest.raises(ValueError):
        jserve.parse_tenant_spec(spec)
    with pytest.raises(ValueError):
        tserve.parse_tenant_spec(spec)


def test_token_bucket_matches_jax():
    # a refill rate far below the test's time scale: both buckets see
    # the same sequence of levels
    ops = [("take", 30), ("take", 30), ("take", 20), ("refund", 15),
           ("take", 16), ("refund", 10_000), ("take", 50), ("take", 1),
           ("refund", 0), ("refund", -3), ("take", 0)]
    buckets = [mod.TokenBucket(rate_per_s=1e-3, burst=50)
               for mod in (jserve, tserve)]
    for op, n in ops:
        got = []
        for b in buckets:
            got.append(b.try_take(n) if op == "take" else b.refund(n))
            got.append(round(b.level, 3))
            got.append(b.retry_after_s(40))
        assert got[:3] == got[3:], (op, n)
    fast = [mod.TokenBucket(rate_per_s=10.0, burst=100.0)
            for mod in (jserve, tserve)]
    for b in fast:
        assert b.try_take(100)
    assert [b.retry_after_s(40) for b in fast] == [4, 4]
    assert [b.retry_after_s(1) for b in fast] == [1, 1]
    for mod in (jserve, tserve):
        with pytest.raises(ValueError):
            mod.TokenBucket(rate_per_s=0, burst=10)
        with pytest.raises(ValueError):
            mod.TokenBucket(rate_per_s=5, burst=0)


# -- DWRR, host side ------------------------------------------------------------


def _req(mod, rid, tenant, cost):
    n = max(1, cost // 2)
    return mod._Request(rid, np.zeros(n, np.int32), cost - n, tenant=tenant)


@pytest.mark.parametrize("weights,tenants,quantum", [
    ({"light": 3, "noisy": 1}, ("light", "noisy"), 64),
    ({"a": 1, "b": 2, "c": 5}, ("a", "b", "c"), 16),
    ({"vip": 4, "*": 1}, ("vip", "x", "y"), 32),
    ({}, ("p", "q"), 256),
], ids=["two", "three", "wildcard", "equal"])
def test_dwrr_picks_match_jax(weights, tenants, quantum):
    """The same saturated, refilled queue through both schedulers: the
    same pick at every step, the same admitted tokens and the 3:1 share
    where the weights say so."""
    scheds = [mod.DwrrScheduler(weights, quantum=quantum)
              for mod in (jcont, tcont)]
    rng = np.random.default_rng(7)
    rid = itertools.count()
    queues = ([], [])
    picks = ([], [])
    for step in range(300):
        # keep every tenant's subqueue non-empty, except that the last
        # tenant goes idle for a while (its deficit must drop)
        for t in tenants:
            idle = t == tenants[-1] and 100 <= step < 150
            while not idle and sum(r.tenant == t for r in queues[0]) < 4:
                r, cost = next(rid), int(rng.integers(8, 60))
                queues[0].append(_req(jcont, r, t, cost))
                queues[1].append(_req(tcont, r, t, cost))
        for sched, q, out in zip(scheds, queues, picks):
            i = sched.pick(q)
            out.append(q[i].rid)
            sched.charge(q.pop(i))
    assert picks[0] == picks[1]
    assert scheds[0].admitted_tokens == scheds[1].admitted_tokens
    assert scheds[0].weight("stranger") == scheds[1].weight("stranger")
    if weights == {"light": 3, "noisy": 1}:
        adm = scheds[1].admitted_tokens
        assert 2.4 <= adm["light"] / adm["noisy"] <= 3.6


def test_dwrr_single_tenant_fifo_and_idle_deficit_drop():
    for mod in (jcont, tcont):
        sched = mod.DwrrScheduler({"a": 5}, quantum=16)
        q = [_req(mod, i, "a", 20) for i in range(4)]
        assert sched.pick(q) == 0
        q2 = [_req(mod, 10 + i, "b", 20) for i in range(4)]
        sched.pick(q2)
        sched.charge(q2[0])
        assert "a" not in sched._deficit
        with pytest.raises(ValueError):
            mod.DwrrScheduler({"a": 0})
        with pytest.raises(ValueError):
            mod.DwrrScheduler({}, quantum=0)


# -- the engine's admission order -----------------------------------------------


def _admission_run(engine, specs):
    """Submit ``(prompt, budget, tenant)`` specs and drain: the
    completion order (one slot: the admission order), the tokens, and
    the per-tenant stats."""
    rids = [engine.submit(p, max_new_tokens=m, tenant=t)
            for p, m, t in specs]
    stats0 = engine.stats
    order, toks = [], {}
    for rid, out in engine.run_until_drained():
        order.append(rid)
        toks[rid] = list(out)
    tenants = {t: s["admitted_tokens"]
               for t, s in engine.stats["tenants"].items()}
    return (order, [toks[r] for r in rids], tenants,
            stats0["fair_active"], stats0["queued_tokens"])


@pytest.mark.parametrize("case", ["two", "three", "longest", "fifo",
                                  "longest_tenants"])
def test_engine_admission_order_matches_jax(lm, case):
    jmodel, params, tmodel = lm
    rng = np.random.default_rng(11)
    tenants = {"two": ("light", "noisy"), "three": ("a", "b", "c"),
               "longest": ("default",), "fifo": ("default",),
               "longest_tenants": ("light", "noisy")}[case]
    weights = {"two": {"light": 3, "noisy": 1},
               "three": {"a": 1, "b": 2, "*": 4},
               "longest_tenants": {"light": 2}}.get(case)
    schedule = "longest" if case.startswith("longest") else "fifo"
    specs = [(rng.integers(1, 97, int(rng.integers(3, 20))),
              int(rng.integers(2, 9)), tenants[i % len(tenants)])
             for i in range(10)]
    slots = 2 if case == "fifo" else 1  # fifo also batches admissions
    kw = dict(num_slots=slots, chunk=2, buckets=(16, 32),
              schedule=schedule, tenant_weights=weights)
    ref = _admission_run(jcont.ContinuousEngine(jmodel, params, **kw), specs)
    got = _admission_run(tcont.ContinuousEngine(tmodel, **kw), specs)
    assert got == ref
    assert got[3] == (len(tenants) > 1)


def test_engine_single_tenant_keeps_batched_fifo(lm):
    _, _, tmodel = lm
    eng = tcont.ContinuousEngine(tmodel, num_slots=2, chunk=2,
                                 buckets=(16,))
    for _ in range(3):
        eng.submit([1, 2], max_new_tokens=2, tenant="alone")
    list(eng.run_until_drained())
    st = eng.stats
    assert st["fair_active"] is False and st["batch_admits"] == 2
    assert st["tenants"]["alone"]["admitted_tokens"] == 3 * 4


# -- the front: sheds, refunds, tenants -----------------------------------------


def _front(lm, kind, **kw):
    jmodel, params, tmodel = lm
    if kind == "jax":
        return jserve._ContinuousFront(jmodel, params, eos_id=None,
                                       num_slots=1, chunk=2, **kw)
    return tserve._ContinuousFront(tmodel, num_slots=1, chunk=2, **kw)


def _stopped(lm, kind, **kw):
    front = _front(lm, kind, **kw)
    front.stop.set()
    front.new_work.set()
    front.thread.join(timeout=10)
    assert not front.thread.is_alive()
    return front


def _outcome(fn):
    """What a front call did: ``("ok", value)`` or the shed/error as a
    comparable tuple (the rejection's reason, status, Retry-After and
    tenant)."""
    try:
        return ("ok", fn())
    except (jserve.RequestRejected, tserve.RequestRejected) as e:
        return ("shed", e.reason, e.status, e.retry_after_s, e.tenant)
    except ValueError as e:
        return ("400", str(e))


def _both(lm, scenario, stopped=True, **kw):
    outs = []
    for kind in ("jax", "torch"):
        front = (_stopped if stopped else _front)(lm, kind, **kw)
        try:
            outs.append(scenario(front))
        finally:
            front.shutdown()
    assert outs[0] == outs[1]
    return outs[1]


def test_front_tenant_quota_shed_with_own_retry_after(lm):
    def scenario(front):
        out = [_outcome(lambda: front.submit([1, 2, 3], 30,
                                             tenant="noisy") >= 0)
               for _ in range(2)]
        out.append(_outcome(lambda: front.submit([1, 2, 3], 30,
                                                 tenant="light") >= 0))
        return out

    out = _both(lm, scenario, tenants="light=3,noisy=1:10:40")
    assert out[0] == ("ok", True) and out[2] == ("ok", True)
    assert out[1][:3] == ("shed", "tenant_quota", 429)
    assert out[1][3] >= 2 and out[1][4] == "noisy"


def test_front_tenant_queue_share_sheds_only_the_hog(lm):
    def scenario(front):
        out = [_outcome(lambda: front.submit([1, 2], 4, tenant="noisy") >= 0)
               for _ in range(3)]
        out += [_outcome(lambda: front.submit([1, 2], 4,
                                              tenant="light") >= 0)
                for _ in range(7)]
        return out

    out = _both(lm, scenario, max_queue_depth=8, tenants="light=3,noisy=1")
    assert out[2] == ("shed", "tenant_queue_full", 429, 1, "noisy")
    assert out[3:9] == [("ok", True)] * 6
    assert out[9] == ("shed", "tenant_queue_full", 429, 1, "light")


def test_front_global_bounds_without_a_spec(lm):
    def scenario(front):
        return [_outcome(lambda: front.submit([1, 2, 3], 8) >= 0)
                for _ in range(2)]

    out = _both(lm, scenario, max_queue_depth=1)
    assert out[1] == ("shed", "queue_full", 429, 1, None)

    def tokens(front):
        return [_outcome(lambda: front.submit([1, 2, 3], 30)),
                _outcome(lambda: front.submit([1, 2, 3], 10) >= 0),
                _outcome(lambda: front.submit([1, 2, 3], 10))]

    out = _both(lm, tokens, max_queued_tokens=20)
    assert out[0][0] == "400" and "request footprint" in out[0][1]
    assert out[2] == ("shed", "queue_full", 429, 1, None)


def test_front_oversize_ask_is_terminal_400(lm):
    def scenario(front):
        return [_outcome(lambda: front.submit([1, 2, 3], 30,
                                              tenant="noisy")),
                _outcome(lambda: front.charge_tokens("noisy", 500))]

    out = _both(lm, scenario, tenants="noisy=1:10:20")
    assert [o[0] for o in out] == ["400", "400"]
    assert all("burst" in o[1] for o in out)


def test_unknown_tenants_fold_into_one_aggregate(lm):
    def scenario(front):
        names = [front.resolve_tenant(t) for t in ("light", "made-up-7",
                                                   None, "*")]
        out = [_outcome(lambda: front.submit([1, 2], 4,
                                             tenant="attacker-0") >= 0),
               _outcome(lambda: front.submit([1, 2], 4,
                                             tenant="attacker-1") >= 0)]
        return names, out, sorted(front.engine.stats["tenants"])

    names, out, tenants = _both(lm, scenario, max_queue_depth=8,
                                tenants="light=3,noisy=1")
    assert names == ["light", "*", "*", "*"]
    assert out[1] == ("shed", "tenant_queue_full", 429, 1, "*")
    assert tenants == ["*"]


def test_no_spec_ignores_client_tenant_ids(lm):
    def scenario(front):
        front.submit([1, 2], 4, tenant="alice")
        front.submit([1, 2], 4, tenant="bob")
        st = front.engine.stats
        return st["fair_active"], sorted(st["tenants"])

    assert _both(lm, scenario) == (False, ["default"])


def test_score_charges_the_tenant_bucket(lm):
    def scenario(front):
        return [_outcome(lambda: front.charge_tokens("noisy", 40)),
                _outcome(lambda: front.charge_tokens("noisy", 40)),
                _outcome(lambda: front.charge_tokens("unlisted", 10_000))]

    out = _both(lm, scenario, tenants="noisy=1:10:50")
    assert out[0] == ("ok", "noisy") and out[2] == ("ok", "*")
    assert out[1][:3] == ("shed", "tenant_quota", 429)
    assert out[1][4] == "noisy"


def _wait_level(bucket, level, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while bucket.level < level and time.monotonic() < deadline:
        time.sleep(0.01)
    return bucket.level


def test_front_refunds_unused_budget_on_deadline_expiry(lm):
    """The charge is prompt + budget at admission; an expired request
    hands its unused budget back."""
    for kind, mod in (("jax", jserve), ("torch", tserve)):
        front = _front(lm, kind, tenants="t=1:1:100")
        try:
            rid = front.submit([1, 2, 3], 60, tenant="t", deadline_s=0.005)
            with pytest.raises(mod.DeadlineExceeded):
                front.wait(rid, timeout_s=120)
            assert _wait_level(front._buckets["t"], 80) >= 80
        finally:
            front.shutdown()


def test_rebuild_refunds_outstanding_quota_charges(lm):
    """A failed step rebuilds the engine and fails its requests, and
    their charges come back (the JAX front's rebuild path, driven by a
    step that raises)."""
    front = _front(lm, "torch", tenants="t=1:1:100")
    try:
        engine = front.engine

        def broken_step():
            raise RuntimeError("injected device failure")

        engine.step = broken_step
        rid = front.submit([1, 2, 3], 60, tenant="t")  # charge 63
        with pytest.raises(RuntimeError, match="injected"):
            front.wait(rid, timeout_s=120)
        assert _wait_level(front._buckets["t"], 95) >= 95
        with front.lock:  # the rebuild completes under the lock
            assert front.engine is not engine
        # the rebuilt engine serves
        rid = front.submit([1, 2, 3], 4, tenant="t")
        assert len(front.wait(rid, timeout_s=120)) == 4
    finally:
        front.shutdown()


def test_quota_vs_drain_composition(lm):
    """Drain beats quota: once draining every tenant gets 503, the
    in-flight request completes and the front drains clean."""
    def scenario(front):
        rid = front.submit([1, 2, 3], 6, tenant="t")
        front.begin_drain()
        shed = _outcome(lambda: front.submit([1, 2], 4, tenant="t"))
        stream = _outcome(lambda: front.submit_stream([1, 2], 4))
        return shed, stream, len(front.wait(rid, timeout_s=120)), \
            front.drain(timeout_s=30)

    shed, stream, n, drained = _both(lm, scenario, stopped=False,
                                     tenants="t=1:1000:2000")
    assert shed == stream == ("shed", "draining", 503, 5, None)
    assert n == 6 and drained
