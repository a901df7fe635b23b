"""PyTorch port, the observability plane (``obs/``) and the fault-point
catalog against the JAX package's modules: the Prometheus text byte for
byte after the same operations, the platform families' names, help
strings, label names and buckets letter for letter, ``traceparent``
parsing on the JAX tests' malformed inputs, the event trail's resume,
rotation and cross-package reads, ``handle_obs_request``'s routes, the
runtime families, and the HTTP server's ``/metrics`` family set against
a JAX replica's.
"""

import json
import os
import threading

import pytest
import torch

from pyspark_tf_gke_tpu.obs import events as jevents
from pyspark_tf_gke_tpu.obs import export as jexport
from pyspark_tf_gke_tpu.obs import metrics as jmetrics
from pyspark_tf_gke_tpu.obs import runtime as jruntime
from pyspark_tf_gke_tpu.obs import trace as jtrace
from pyspark_tf_gke_tpu_torch.chaos import inject as tinject
from pyspark_tf_gke_tpu_torch.obs import events as tevents
from pyspark_tf_gke_tpu_torch.obs import export as texport
from pyspark_tf_gke_tpu_torch.obs import metrics as tmetrics
from pyspark_tf_gke_tpu_torch.obs import runtime as truntime
from pyspark_tf_gke_tpu_torch.obs import trace as ttrace

torch.set_num_threads(1)

GOLDEN = (
    "# HELP aa_gauge a gauge\n"
    "# TYPE aa_gauge gauge\n"
    "aa_gauge 2.5\n"
    "# HELP bb_total a counter\n"
    "# TYPE bb_total counter\n"
    "bb_total 3\n"
    "# HELP cc_ms a histogram\n"
    "# TYPE cc_ms histogram\n"
    'cc_ms_bucket{le="1"} 0\n'
    'cc_ms_bucket{le="2"} 1\n'
    'cc_ms_bucket{le="+Inf"} 1\n'
    "cc_ms_sum 1.5\n"
    "cc_ms_count 1\n"
)


def _golden_ops(mod):
    r = mod.MetricsRegistry()
    r.gauge("aa_gauge", "a gauge").set(2.5)
    r.counter("bb_total", "a counter").inc(3)
    r.histogram("cc_ms", "a histogram", buckets=(1.0, 2.0)).observe(1.5)
    return r


def _rich_ops(mod):
    """Labels with escapes, lazy gauges, default buckets, exemplars,
    non-integer values."""
    r = mod.MetricsRegistry()
    c = r.counter("req_total", "requests", labelnames=("path", "code"))
    c.labels(path="/v1/generate", code="200").inc(7)
    c.labels("/v1/score", "4\"0\\0\n").inc(0.25)
    g = r.gauge("lazy_bytes", "lazy")
    g.set_function(lambda: 12345.678)
    r.gauge("neg", "").set(-3)
    h = r.histogram("lat_ms", "latency", labelnames=("phase",))
    for i, v in enumerate((0.1, 0.3, 7.0, 900.0, 1e6)):
        h.labels(phase="a" if i % 2 else "b").observe(v, exemplar=f"t{i}")
    return r


@pytest.mark.parametrize("ops", [_golden_ops, _rich_ops],
                         ids=["golden", "labels_lazy_exemplars"])
def test_prometheus_text_equals_the_jax_registry(ops):
    got, want = ops(tmetrics), ops(jmetrics)
    assert got.exposition() == want.exposition()
    assert json.loads(got.snapshot_json()) == json.loads(want.snapshot_json())
    if ops is _golden_ops:
        assert got.exposition() == GOLDEN


def _families(fam):
    out = {}
    for key, m in fam.items():
        out[key] = (m.name, m.kind, m.help, m.labelnames,
                    getattr(m, "buckets", None))
    return out


def test_platform_families_letter_for_letter():
    """Every family the port registers is the JAX package's, letter for
    letter; the port carries every ``train_`` / ``serve_`` /
    ``runtime_`` family of the JAX package (the pipeline and data-plane
    families wait for their planes)."""
    got = _families(tmetrics.platform_families(tmetrics.MetricsRegistry()))
    want = _families(jmetrics.platform_families(jmetrics.MetricsRegistry()))
    assert all(got[k] == want[k] for k in got)
    planes = ("train_", "serve_", "runtime_")
    assert {k for k in want if k.startswith(planes)} <= set(got)
    assert set(want) - set(got) == {k for k in want if k.startswith(
        ("pipeline_", "data_"))}
    assert (_families(tmetrics.chaos_families(tmetrics.MetricsRegistry()))
            == _families(jmetrics.chaos_families(
                jmetrics.MetricsRegistry())))
    assert tmetrics.DEFAULT_LATENCY_BUCKETS_MS == \
        jmetrics.DEFAULT_LATENCY_BUCKETS_MS


def test_registration_conflicts_raise_and_are_recorded():
    r = tmetrics.MetricsRegistry()
    a = r.counter("t_port_conflict_total", "x", labelnames=("a",))
    assert r.counter("t_port_conflict_total", "x", labelnames=("a",)) is a
    with pytest.raises(tmetrics.MetricsError):
        r.gauge("t_port_conflict_total")
    tmetrics.MetricsRegistry().gauge("t_port_conflict_total")
    assert "t_port_conflict_total" in " ".join(
        tmetrics.duplicate_metric_conflicts())


def test_runtime_families_names_and_cpu_values():
    got = truntime.install_runtime_metrics(tmetrics.MetricsRegistry())
    want = jruntime.install_runtime_metrics(jmetrics.MetricsRegistry())
    assert sorted(got) == sorted(want)
    assert [got[k].name for k in sorted(got)] == \
        [want[k].name for k in sorted(want)]
    assert got["runtime_process_rss_bytes"].value > 0
    assert got["runtime_jax_device_count"].value == torch.cuda.device_count()
    assert got["runtime_live_array_bytes"].value == 0  # no card here
    assert got["runtime_uptime_seconds"].value >= 0
    assert "torch.cuda" in got["runtime_live_array_bytes"].help


TID, SID = "ab" * 16, "cd" * 8
GOOD = f"00-{TID}-{SID}-01"
MALFORMED = [
    None, 42, "", "garbage", GOOD[:-4], GOOD.replace("00-", "ff-"),
    f"00-{TID}-{SID}-01-extra", f"00-{'0' * 32}-{SID}-01",
    f"00-{TID}-{'0' * 16}-01", f"00-{TID[:-2]}-{SID}-01",
    f"00-{TID.upper()}-{SID}-01", f"00-{TID}-{SID}-zz",
    f"0-{TID}-{SID}-01", GOOD, f"00-{TID}-{SID}-00",
    f"42-{TID}-{SID}-01-future",
]


@pytest.mark.parametrize("value", MALFORMED,
                         ids=[f"case{i}" for i in range(len(MALFORMED))])
def test_traceparent_parsing_equals_the_jax_parser(value):
    assert ttrace.parse_traceparent(value) == jtrace.parse_traceparent(value)


def test_traceparent_round_trip_and_recorder_sampling():
    tid, sid = ttrace.new_trace_id(), ttrace.new_span_id()
    for sampled in (True, False):
        header = ttrace.format_traceparent(tid, sid, sampled)
        assert header == jtrace.format_traceparent(tid, sid, sampled)
        assert ttrace.parse_traceparent(header) == (tid, sid, sampled)
    off = ttrace.TraceRecorder(sample=0.0, slow_ms=0.0)
    span = off.start_span("req")
    span.event("first_token", ttft_ms=1.0)
    span.finish()
    assert not span.recording and off.traces() == []
    slow = ttrace.TraceRecorder(sample=0.0, slow_ms=1e-6)
    sp = slow.start_span("req")
    sp.event("x")
    sp.finish()
    assert [t["trace_id"] for t in slow.traces()] == [sp.trace_id]


def test_event_log_resumes_rotates_and_reads_across_packages(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    tevents.EventLog(path).emit("first")
    assert tevents.EventLog(path).emit("second")["seq"] == 1
    # a JAX process reopening the trail resumes the same sequence
    assert jevents.EventLog(path).emit("third")["seq"] == 2
    assert [e["kind"] for e in tevents.read_events(path)] == \
        ["first", "second", "third"]
    rot = str(tmp_path / "rot.jsonl")
    log = tevents.EventLog(rot, max_bytes=400)
    for i in range(100):
        log.emit("tick", i=i)
    assert os.path.getsize(rot) < 1600 and os.path.exists(rot + ".1")
    current = list(jevents.read_events(rot))
    assert current[-1]["seq"] == 99
    assert [e["seq"] for e in current] == sorted(e["seq"] for e in current)
    with open(rot, "a") as fh:
        fh.write('{"torn": ')
    assert list(tevents.read_events(rot))[-1]["seq"] == 99


def test_append_jsonl_line_is_line_atomic(tmp_path):
    path = str(tmp_path / "trail.jsonl")

    def worker(tag):
        for i in range(100):
            tevents.append_jsonl_line(path, {"tag": tag, "i": i})

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    assert len(rows) == 400


def _obs_fixture(mod_metrics, mod_events, mod_trace, tmp_path, tag):
    r = mod_metrics.MetricsRegistry()
    r.counter("t_route_total", "routes").inc()
    log = mod_events.EventLog(str(tmp_path / f"{tag}.jsonl"))
    log.emit("hello", x=1)
    rec = mod_trace.TraceRecorder(sample=1.0)
    for name in ("a", "b"):
        rec.start_span(name).finish()
    return r, log, rec


PATHS = ["/metrics", "/metrics.json", "/events?n=5", "/events?n=x",
         "/traces", "/traces?n=1", "/traces?slow_ms=60000",
         "/traces?slow_ms=junk", "/traces?format=jsonl",
         "/traces?format=xml", "/stepz?n=2", "/stepz?n=x", "/nope"]


def test_handle_obs_request_routes_equal_the_jax_handlers(tmp_path):
    from pyspark_tf_gke_tpu.obs.stepstats import StepStatsRing as JRing
    from pyspark_tf_gke_tpu_torch.obs.stepstats import StepStatsRing

    t = _obs_fixture(tmetrics, tevents, ttrace, tmp_path, "t")
    j = _obs_fixture(jmetrics, jevents, jtrace, tmp_path, "j")
    for path in PATHS:
        got = texport.handle_obs_request(path, t[0], t[1], tracer=t[2],
                                         stepstats=StepStatsRing(),
                                         extra_exposition="x 1\n")
        want = jexport.handle_obs_request(path, j[0], j[1], tracer=j[2],
                                          stepstats=JRing(),
                                          extra_exposition="x 1\n")
        if want is None:
            assert got is None, path
            continue
        assert got[:2] == want[:2], path
        if path.startswith("/metrics"):
            assert got[2] == want[2], path
        elif path.startswith(("/traces?n", "/events?n=5")):
            key = "traces" if "traces" in path else "events"
            assert len(json.loads(got[2])[key]) == len(
                json.loads(want[2])[key]), path
    assert texport.handle_obs_request("/traces", t[0]) is None


def test_textfile_exporter_writes_atomically(tmp_path):
    r = tmetrics.MetricsRegistry()
    r.counter("t_export_total", "x").inc(2)
    path = str(tmp_path / "sub" / "metrics.prom")
    exp = texport.TextfileExporter(r, path, interval_s=0.1).start()
    exp.stop()
    with open(path) as fh:
        assert "t_export_total 2" in fh.read()
    assert not [p for p in os.listdir(tmp_path / "sub") if ".tmp." in p]


def test_fault_point_catalog_equals_the_jax_one():
    from pyspark_tf_gke_tpu.chaos import inject as jinject

    assert tinject.FAULT_POINTS == jinject.FAULT_POINTS
    from pyspark_tf_gke_tpu.replay.spec import splitmix64_stream

    a, b = tinject.splitmix64_stream("k:1"), splitmix64_stream("k:1")
    assert [next(a) for _ in range(32)] == [next(b) for _ in range(32)]
    with pytest.raises(ValueError, match="unknown fault point"):
        tinject.ChaosInjector.from_spec("not.a.point:fail@1")
    legacy, named = tinject.split_serve_chaos_spec(
        "fail@3,slow@4:0.5,serve.request:fail@2,seed=4")
    jlegacy, jnamed = jinject.split_serve_chaos_spec(
        "fail@3,slow@4:0.5,serve.request:fail@2,seed=4")
    assert legacy.pending == jlegacy.pending
    assert legacy.slow_pending == jlegacy.slow_pending
    assert named.describe() == jnamed.describe()


def test_fired_fault_lands_on_the_trail_and_the_counter(tmp_path):
    reg = tmetrics.MetricsRegistry()
    tmetrics.set_registry(reg)
    tevents.set_event_log(tevents.EventLog(str(tmp_path / "ev.jsonl")))
    try:
        tinject.install(tinject.ChaosInjector.from_spec(
            "serve.request:fail@2"))
        tinject.chaos_fire("serve.request")
        with pytest.raises(tinject.InjectedFault):
            tinject.chaos_fire("serve.request", rid=7)
        ev = tevents.get_event_log().tail(1)[0]
        assert ev["kind"] == "fault_injected" and ev["invocation"] == 2
        assert ev["rid"] == "7"
        assert ('fault_injections_total{point="serve.request",'
                'action="fail"} 1') in reg.exposition()
    finally:
        tinject.uninstall()
        tmetrics.set_registry(None)
        tevents.set_event_log(None)


def test_retry_with_backoff_counts_and_gives_up():
    from pyspark_tf_gke_tpu_torch.train.resilience import retry_with_backoff

    reg = tmetrics.MetricsRegistry()
    tmetrics.set_registry(reg)
    calls, sleeps = [], []
    try:
        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("blip")
            return "ok"

        assert retry_with_backoff(flaky, op="bundle_load",
                                  sleep=sleeps.append) == "ok"
        assert len(calls) == 3 and len(sleeps) == 2
        assert 'retries_total{op="bundle_load"} 2' in reg.exposition()
        with pytest.raises(FileNotFoundError):
            retry_with_backoff(lambda: open("/nonexistent/x"),
                               give_up_on=(FileNotFoundError,),
                               sleep=sleeps.append)
        assert len(sleeps) == 2
    finally:
        tmetrics.set_registry(None)
