"""PyTorch port, the step watchdog, the fault points and the driver
loop's heartbeat and chaos (the cases of ``tests/test_chaos.py`` and
``tests/test_serve_lifecycle.py`` on the port's ``_ContinuousFront``):

* a hung device step (``engine.device_step:hang``) past the step timeout
  gets every waiter an ``EngineWedged`` terminal long before the step
  returns; the engine rebuilds when it does and serves the JAX engine's
  tokens again (decode-ahead depths 0 and 1);
* a failed device step gives every in-flight request exactly one
  terminal (the JAX package's ``check_traces`` and ``check_front`` audit
  it); a failed admission returns its pages;
* the ``--chaos`` driver-loop tokens, the named points firing the same
  invocations as the JAX ``ChaosInjector`` for a seed, the heartbeat
  file and ``/livez``'s loop age.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.chaos import inject as jinject
from pyspark_tf_gke_tpu.chaos.invariants import (check_engine, check_front,
                                                 check_traces)
from pyspark_tf_gke_tpu.models import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.train.continuous import ContinuousEngine as JaxEngine
from pyspark_tf_gke_tpu_torch.chaos import inject
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.obs.events import EventLog
from pyspark_tf_gke_tpu_torch.obs.metrics import (MetricsRegistry,
                                                  platform_families)
from pyspark_tf_gke_tpu_torch.obs.trace import TraceRecorder
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)
from pyspark_tf_gke_tpu_torch.train.resilience import Heartbeat
from pyspark_tf_gke_tpu_torch.train.serve import _ContinuousFront

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    inject.uninstall()
    jinject.uninstall()
    yield
    inject.uninstall()
    jinject.uninstall()


@pytest.fixture(scope="module")
def models():
    cfg = CausalLMConfig(vocab_size=97, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64, max_seq_len=64,
                         dtype=jnp.float32, kv_page_size=16, kv_num_pages=24)
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(params)).eval()
    return jmodel, params, tmodel


def _reference(models, prompt, n):
    jmodel, params, _ = models
    eng = JaxEngine(jmodel, params, num_slots=1, chunk=2)
    rid = eng.submit(np.asarray(prompt, np.int32), n)
    return dict(eng.run_until_drained())[rid]


def _front(models, **kw):
    fam = platform_families(MetricsRegistry())
    front = _ContinuousFront(models[2], obs=fam, event_log=kw.pop(
        "event_log", None), **kw)
    return front, fam


def _wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


@pytest.mark.parametrize("depth", [0, 1])
def test_hung_step_watchdog_reaps_then_engine_recovers(models, depth,
                                                       tmp_path):
    """A device step held 1.5 s past a 0.2 s timeout: the waiter's
    EngineWedged arrives from the watchdog, the hung step's record is
    relabeled ``reaped`` once, the engine rebuilds when the step returns
    and serves the JAX engine's tokens."""
    hang_s = 1.5
    front, fam = _front(models, num_slots=1, chunk=2, pipeline_depth=depth,
                        event_log=EventLog(str(tmp_path / "ev.jsonl")))
    try:
        warm = front.submit([1, 2, 3], 2)
        assert len(front.wait(warm, timeout_s=60)) == 2
        seq0 = front.stepstats.next_seq
        front.step_timeout_s = 0.2
        inject.install(inject.ChaosInjector.from_spec(
            f"engine.device_step:hang@{depth + 1}:{hang_s}"))
        rid = front.submit([4, 5, 6], 8)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="watchdog"):
            front.wait(rid, timeout_s=30)
        assert time.monotonic() - t0 < hang_s * 0.75
        assert fam["serve_step_watchdog_reaps_total"].value >= 1
        _wait_for(lambda: fam["serve_engine_rebuilds_total"].value >= 1)
        inject.uninstall()
        rid2 = front.submit([7, 8], 3)
        assert front.wait(rid2, timeout_s=60) == _reference(models, [7, 8], 3)
        reaped = [r for r in front.stepstats.snapshot(n=1024)
                  if r["outcome"] == "reaped"]
        assert len(reaped) == 1 and reaped[0]["seq"] >= seq0
        kinds = [e["kind"] for e in front._event_log.tail(20)]
        assert "engine_watchdog_reap" in kinds and "engine_rebuilt" in kinds
        out = check_front(front)
        assert out["ok"], out["violations"]
    finally:
        front.shutdown()


def test_device_step_fault_gives_exactly_one_terminal(models):
    """``engine.device_step:fail`` mid-traffic: every in-flight request
    gets exactly one terminal, the engine rebuilds, a fresh request
    completes; the JAX checkers audit the traces and the front."""
    front, fam = _front(models, num_slots=2, chunk=2, pipeline_depth=1)
    rec = TraceRecorder(sample=1.0)
    try:
        warm = front.submit([1, 2, 3], 2)
        assert len(front.wait(warm, timeout_s=60)) == 2
        inject.install(inject.ChaosInjector.from_spec(
            "engine.device_step:fail@2"))
        spans = [rec.start_span(f"req{i}") for i in range(2)]
        rids = [front.submit([4 + i, 5, 6], 8, span=spans[i])
                for i in range(2)]
        outcomes = []
        for rid in rids:
            try:
                front.wait(rid, timeout_s=60)
                outcomes.append("ok")
            except RuntimeError:
                outcomes.append("error")
        assert "error" in outcomes
        assert fam["serve_engine_rebuilds_total"].value == 1
        for sp in spans:
            sp.finish()
        traces = check_traces(rec.traces())
        assert traces["ok"] and traces["request_spans"] == 2, traces
        rid = front.submit([9, 9, 9], 3)
        assert len(front.wait(rid, timeout_s=60)) == 3
        assert not front.engine._inflight_q
        assert check_front(front)["ok"]
        assert check_engine(front.engine)["ok"]
    finally:
        front.shutdown()


def test_admit_fault_returns_pages_and_engine_keeps_serving(models):
    """``engine.admit`` fires after the page allocation: every held page
    returns, the request stays queued, and the same engine completes it
    with the JAX engine's tokens once the fault is spent."""
    eng = ContinuousEngine(models[2], num_slots=2, chunk=4)
    rid = eng.submit([5, 6, 7, 8], 4)
    inject.install(inject.ChaosInjector.from_spec("engine.admit:fail@1"))
    with pytest.raises(inject.InjectedFault):
        eng.step()
    assert not eng._page_refs and not eng._slots
    assert eng.queue_depth() == 1
    done = dict(eng.run_until_drained())
    assert done[rid] == _reference(models, [5, 6, 7, 8], 4)
    out = check_engine(eng)
    assert out["ok"], out["violations"]


def test_cancel_and_rebuild_terminals(models):
    """One ``cancelled`` terminal on a cancel; ``fail_outstanding`` gives
    each undelivered request one ``error`` terminal."""
    rec = TraceRecorder(sample=1.0)
    eng = ContinuousEngine(models[2], num_slots=1, chunk=2)
    spans = [rec.start_span(f"req{i}") for i in range(3)]
    rids = [eng.submit([1 + i, 2, 3], 8, span=sp)
            for i, sp in enumerate(spans)]
    assert eng.cancel(rids[0])
    eng.step()
    failed = eng.fail_outstanding("error")
    assert sorted(r.rid for r in failed) == rids[1:]
    for sp in spans:
        sp.finish()
    out = check_traces(rec.traces())
    assert out["ok"] and out["request_spans"] == 3, out["violations"]
    outcomes = sorted(e["outcome"] for t in rec.traces()
                      for s in t["spans"] for e in s["events"]
                      if e["name"] == "terminal")
    assert outcomes == ["cancelled", "error", "error"]


def test_chaos_spec_injects_into_driver_loop(models):
    """``--chaos fail@2``: the second busy iteration raises in the driver
    loop, the waiter fails, the engine rebuilds and serves."""
    chaos, named = inject.split_serve_chaos_spec("fail@2,slow@1:0.01")
    assert named is None
    front, fam = _front(models, num_slots=1, chunk=2, chaos=chaos)
    try:
        rid = front.submit([1, 2, 3], 8)
        with pytest.raises(RuntimeError):
            front.wait(rid, timeout_s=60)
        assert chaos.fired_faults == 1 and not chaos.slow_pending
        assert fam["serve_engine_rebuilds_total"].value == 1
        rid = front.submit([1, 2, 3], 4)
        assert front.wait(rid, timeout_s=60) == _reference(models,
                                                           [1, 2, 3], 4)
    finally:
        front.shutdown()


SPECS = ["serve.request:fail%0.3,seed=5",
         "engine.device_step:fail%0.25x4,engine.admit:slow%0.5:0.001,seed=9",
         "bundle.load:fail@3,serve.request:fail%0.1,seed=123"]


@pytest.mark.parametrize("spec", SPECS)
def test_named_points_fire_the_jax_injectors_invocations(spec):
    """One spec and seed fire the same invocations of each point in both
    packages (the same splitmix64 rule streams)."""
    points = ("serve.request", "engine.device_step", "engine.admit",
              "bundle.load")

    def run(mod):
        inj = mod.ChaosInjector.from_spec(spec)
        assert inj.describe() == jinject.ChaosInjector.from_spec(
            spec).describe()
        for i in range(40):
            for point in points:
                try:
                    inj.fire(point)
                except mod.InjectedFault:
                    pass
        return [(f["point"], f["action"], f["invocation"])
                for f in inj.fired]

    got, want = run(inject), run(jinject)
    assert got == want and got


def test_heartbeat_beats_from_driver_loop(models, tmp_path):
    hb = str(tmp_path / "serve-hb.json")
    front, _ = _front(models, num_slots=1, chunk=2,
                      heartbeat=Heartbeat(hb, every_steps=1))
    try:
        rid = front.submit([1, 2, 3], 4)
        assert len(front.wait(rid, timeout_s=60)) == 4
        _wait_for(lambda: Heartbeat.age(hb) is not None)
        step0 = Heartbeat.read(hb)["step"]
        assert Heartbeat.age(hb) < 10
        assert not Heartbeat.is_stalled(hb, stall_seconds=30)
        _wait_for(lambda: Heartbeat.read(hb)["step"] > step0)
    finally:
        front.shutdown()
    time.sleep(0.2)
    assert Heartbeat.is_stalled(hb, stall_seconds=0.1)
    assert not Heartbeat.is_stalled(str(tmp_path / "never.json"), 0.1)


def test_livez_reports_loop_age_and_wedge(models):
    """``/livez``'s fields: the loop age stays fresh while alive, and a
    hung step past ``--live-stall`` reads not live and wedged."""
    from pyspark_tf_gke_tpu_torch.train.serve import BundleServer

    server = BundleServer.__new__(BundleServer)
    front, _ = _front(models, num_slots=1, chunk=2)
    server._front, server._live_stall_s = front, 0.3
    server._draining = threading.Event()
    try:
        time.sleep(0.2)
        out = server.livez()
        assert out["live"] and not out["wedged"]
        assert out["driver_loop_age_s"] < 0.3 and out["step_timeout_s"] == 0
        front.step_timeout_s = 0.2
        inject.install(inject.ChaosInjector.from_spec(
            "engine.device_step:hang@1:1.2"))
        rid = front.submit([1, 2, 3], 4)
        with pytest.raises(RuntimeError, match="watchdog"):
            front.wait(rid, timeout_s=30)
        time.sleep(0.3)
        out = server.livez()
        assert not out["live"] and out["wedged"]
        _wait_for(lambda: server.livez()["live"])
    finally:
        front.shutdown()
