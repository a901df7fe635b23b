"""PyTorch port, step telemetry: the port's ``StepStatsRing`` and the JAX
one (``pyspark_tf_gke_tpu/obs/stepstats.py``), fed the same records and
device-busy intervals on the same fake clock, give equal ``summary()``
dicts and snapshots (the interval-union idle fraction, the serial-loop
fallback, delivery amends, reaped and error outcomes); ``flops_per_token``
agrees; a pipelined port engine closes exactly one record for each step
that did work — as many as the JAX engine closes on the same traffic —
and closes a failing step as "error".
"""

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.models.causal_lm import CausalLMConfig as JaxConfig
from pyspark_tf_gke_tpu.obs import stepstats as jss
from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
from pyspark_tf_gke_tpu_torch.obs import stepstats as tss
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from tests.test_torch_engine import CB_SMOKE, JaxEngine, _models

torch.set_num_threads(1)


class _Clock:
    """A clock that advances by a fixed sequence of steps per call."""

    def __init__(self, steps):
        self.t = 100.0
        self.steps = list(steps)
        self.i = 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def _feed(mod, scenario, obs=None):
    ring = mod.StepStatsRing(capacity=8, window=6,
                             clock=_Clock([0.003, 0.011, 0.0007, 0.02]))
    ring.bind(obs, flops_per_token=1e6, peak_flops=1e12)
    for i in range(scenario["steps"]):
        rec = ring.begin(queue_depth=i % 3)
        with rec.phase("schedule"):
            pass
        with rec.phase("dispatch"):
            with rec.phase("device_wait"):
                pass
        with rec.phase("collect"):
            pass
        rec.decode_slots = (i % 4) + 1
        rec.tokens_out = 3 * i
        rec.prefill_tokens = 16 if i % 2 else 0
        rec.prefill_pieces = i % 2
        if scenario.get("intervals"):
            t = ring._clock()
            ring.note_device_interval(t - 0.004 * (i % 3 + 1), t + 0.001)
        ring.close(rec, outcome="error" if i == scenario.get("error")
                   else None)
        if i == scenario.get("reaped"):
            ring.mark_reaped(rec)
        if scenario.get("deliver"):
            ring.add_deliver(rec, 0.5 * i)
    assert ring.close(rec) is False  # a second close is a no-op
    return ring


SCENARIOS = {
    "empty": dict(steps=0),
    "serial_fallback": dict(steps=5),
    "intervals": dict(steps=9, intervals=True),
    "amends": dict(steps=7, intervals=True, deliver=True, reaped=2,
                   error=4),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ring_matches_jax_ring(name):
    scenario = SCENARIOS[name]
    if not scenario["steps"]:
        assert (tss.StepStatsRing().summary()
                == jss.StepStatsRing().summary())
        return
    got, ref = _feed(tss, scenario), _feed(jss, scenario)
    assert got.summary() == ref.summary()
    assert got.snapshot(n=8) == ref.snapshot(n=8)
    assert got.snapshot(n=8, min_ms=10.0) == ref.snapshot(n=8, min_ms=10.0)
    assert got.host_overhead_frac() == ref.host_overhead_frac()
    assert len(got) == len(ref) and got.next_seq == ref.next_seq
    assert tss.PHASES == jss.PHASES


@pytest.mark.parametrize("name", ["intervals", "amends"])
def test_bound_ring_metrics_equal_the_jax_rings(name):
    """Bound to a registry, the port's ring gives the JAX ring's step
    histograms and windowed gauges (read when scraped here, set at each
    close there) after the same records."""
    from pyspark_tf_gke_tpu.obs import metrics as jmetrics
    from pyspark_tf_gke_tpu_torch.obs import metrics as tmetrics

    regs = (tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    _feed(tss, SCENARIOS[name], tmetrics.platform_families(regs[0]))
    _feed(jss, SCENARIOS[name], jmetrics.platform_families(regs[1]))
    keep = ("serve_step_", "serve_device_idle_fraction", "serve_mfu")
    got, want = ([line for line in r.exposition().splitlines()
                  if line.lstrip("# HELPTYPE").startswith(keep)]
                 for r in regs)
    assert got == want and any("serve_mfu " in line for line in got)


@pytest.mark.parametrize("widths", [
    dict(), dict(num_kv_heads=4, ffn="swiglu", max_seq_len=2048),
    dict(hidden_size=1280, num_heads=20, intermediate_size=5120)])
def test_flops_per_token_matches_jax(widths):
    assert (tss.flops_per_token(CausalLMConfig(**widths))
            == jss.flops_per_token(JaxConfig(**widths)) > 0)
    assert tss.flops_per_token(object()) == 0.0


def _drive_counting(engine, specs):
    """Submit everything, step to the end; returns how many steps did
    work (the ones that should close a record)."""
    for p, m in specs:
        engine.submit(p, max_new_tokens=m)
    worked = 0
    while engine.busy:
        before = (engine._n_dispatched_steps, engine._n_prefill_tokens,
                  engine._n_finished)
        engine.step()
        after = (engine._n_dispatched_steps, engine._n_prefill_tokens,
                 engine._n_finished)
        worked += after != before
    return worked


def test_pipelined_engine_closes_one_record_per_working_step():
    jmodel, params, tmodel = _models(pos="learned", page_size=16,
                                     num_pages=32, **CB_SMOKE)
    rng = np.random.default_rng(12)
    specs = [(rng.integers(1, 512, n), m)
             for n, m in [(5, 9), (40, 4), (17, 12), (9, 6)]]
    kw = dict(num_slots=2, chunk=4, buckets=(16, 32, 64), pipeline_depth=1)
    eng = ContinuousEngine(tmodel, **kw)
    worked = _drive_counting(eng, specs)
    jeng = JaxEngine(jmodel, params, **kw)
    _drive_counting(jeng, specs)
    ring = eng.stepstats
    assert len(ring) == worked == len(jeng.stepstats)
    rows = ring.snapshot(n=256)
    assert all(r["outcome"] == "ok" for r in rows)
    assert sum(r["tokens_out"] for r in rows) == sum(m for _, m in specs)
    summary = eng.stats["step_phases"]
    assert summary["records"] == worked
    assert set(summary) == set(jeng.stats["step_phases"])
    assert 0.0 <= summary["host_overhead_frac"] <= 1.0
    assert eng.stats["inflight"] is False

    def failing(size):
        raise RuntimeError("injected dispatch fault")

    eng.submit(specs[0][0], max_new_tokens=4)
    eng._dispatch_chunk = failing
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert len(ring) == worked + 1
    assert ring.snapshot(n=1)[0]["outcome"] == "error"
