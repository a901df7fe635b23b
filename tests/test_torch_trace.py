"""PyTorch port, request tracing: the HTTP handler adopts ``traceparent``
(or mints a root) and echoes ``X-Request-Id`` on every reply, a
keep-alive GET never echoes an earlier POST's id, sheds are traced, SSE
streams open with a ``: trace_id=`` comment, ``/traces`` filters; the
engine annotates a request's span as the JAX engine does (the same event
sequence and admission routes on the same workload); the JAX package's
``RouterServer`` carries one trace into a torch replica, and its
``replay.extract`` and ``chaos.invariants.check_traces`` accept a torch
replica's ``/traces`` export.
"""

import dataclasses
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.chaos.invariants import check_traces
from pyspark_tf_gke_tpu.models import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.obs.events import EventLog as JaxEventLog
from pyspark_tf_gke_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from pyspark_tf_gke_tpu.obs.trace import TraceRecorder as JaxRecorder
from pyspark_tf_gke_tpu.replay.extract import parse_traces, spec_from_traces
from pyspark_tf_gke_tpu.train import export as jexport
from pyspark_tf_gke_tpu.train.continuous import ContinuousEngine as JaxEngine
from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
from pyspark_tf_gke_tpu_torch.obs.trace import (TraceRecorder,
                                                format_traceparent,
                                                new_span_id, new_trace_id)
from pyspark_tf_gke_tpu_torch.train import export as texport
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                  start_http_server)

torch.set_num_threads(1)

CFG = dict(vocab_size=259, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_seq_len=128, dtype=jnp.float32,
           kv_page_size=16, kv_num_pages=32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX model and params, the converted torch model, and the
    torch bundle directory."""
    cfg = CausalLMConfig(**CFG)
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(2), jnp.ones((1, 8), jnp.int32))["params"]))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tdir = texport.export_serving_bundle(
        texport.config_from_dict(fields), texport.params_from_flax(params),
        str(tmp_path_factory.mktemp("trace") / "bundle"), quantize=False)
    tmodel = texport.load_serving_bundle(tdir, "cpu")[0]
    return jmodel, params, tmodel, tdir


def _start(server):
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def served(models):
    server = BundleServer(models[3], device="cpu", continuous_slots=2,
                          continuous_chunk=4, trace_sample=1.0,
                          trace_slow_ms=0.0, registry=MetricsRegistry())
    httpd, url = _start(server)
    yield server, url
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()


def _post(url, body, headers=None, path="/v1/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers, json.loads(err.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _wait_trace(recorder, trace_id, timeout_s=5.0):
    """The handler finishes its span just after the reply leaves."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        found = recorder.traces(trace_id=trace_id)
        if found:
            return found
        time.sleep(0.01)
    return recorder.traces(trace_id=trace_id)


def test_handler_adopts_traceparent_and_echoes_request_id(served):
    server, url = served
    tid = new_trace_id()
    status, hdrs, body = _post(url, {"prompts": ["trace me"],
                                     "max_new_tokens": 6}, headers={
        "traceparent": format_traceparent(tid, new_span_id(), True)})
    assert status == 200 and hdrs["X-Request-Id"] == tid
    [trace] = _wait_trace(server.tracer, tid)
    [span] = trace["spans"]
    assert span["name"] == "serve.request"
    assert span["attrs"]["http.status"] == 200
    assert span["attrs"]["prompt_tokens"] == len(b"trace me")
    names = [e["name"] for e in span["events"]]
    assert names[:2] == ["queue_wait", "admission"]
    assert "first_token" in names and names[-1] == "terminal"
    # a malformed traceparent mints a new root, never an error
    status, hdrs, _ = _post(url, {"prompts": ["x"], "max_new_tokens": 2},
                            headers={"traceparent": "garbage"})
    assert status == 200 and len(hdrs["X-Request-Id"]) == 32


def test_keep_alive_get_does_not_echo_previous_posts_trace_id(served):
    _, url = served
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/generate",
                     body=json.dumps({"prompts": ["x"],
                                      "max_new_tokens": 2}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.getheader("X-Request-Id")
        resp.read()
        conn.request("GET", "/metrics.json")  # the same connection
        resp = conn.getresponse()
        assert resp.getheader("X-Request-Id") is None
        resp.read()
    finally:
        conn.close()


def test_shed_traces_with_request_id(models):
    """A tenant's quota shed (429) echoes its trace id, and the trace
    carries the ``shed`` verdict with the reason and the tenant."""
    server = BundleServer(models[3], device="cpu", continuous_slots=1,
                          continuous_chunk=4, tenants_spec="capped=1:1:8",
                          trace_sample=1.0, registry=MetricsRegistry())
    httpd, url = _start(server)
    try:
        body = {"prompts": ["abc"], "max_new_tokens": 4}
        assert _post(url, body, {"X-Tenant": "capped"})[0] == 200
        status, hdrs, out = _post(url, body, {"X-Tenant": "capped"})
        assert status == 429 and out["reason"] == "tenant_quota"
        tid = hdrs["X-Request-Id"]
        assert tid and len(tid) == 32
        [trace] = _wait_trace(server.tracer, tid)
        events = [e for s in trace["spans"] for e in s["events"]]
        shed = next(e for e in events if e["name"] == "shed")
        assert shed["reason"] == "tenant_quota" and shed["tenant"] == "capped"
        assert trace["spans"][0]["attrs"]["http.status"] == 429
        assert check_traces(server.tracer.traces())["ok"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()


def test_sse_stream_opens_with_the_trace_id(served):
    _, url = served
    tid = new_trace_id()
    req = urllib.request.Request(
        url + "/v1/generate",
        data=json.dumps({"prompt": "stream", "stream": True,
                         "max_new_tokens": 5}).encode(),
        headers={"traceparent": format_traceparent(tid, new_span_id(),
                                                   True)})
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["X-Request-Id"] == tid
        raw = resp.read().decode()
    assert raw.startswith(f": trace_id={tid}\n\n")
    assert raw.endswith("data: [DONE]\n\n")


def test_traces_endpoint_filters(served):
    server, url = served
    for i in range(3):
        _post(url, {"prompts": [f"filter {i}"], "max_new_tokens": 3})
    time.sleep(0.1)
    status, body = _get(url, "/traces")
    out = json.loads(body)
    assert status == 200 and out["enabled"] and out["sample"] == 1.0
    tid = out["traces"][0]["trace_id"]
    status, body = _get(url, f"/traces?trace_id={tid}")
    assert [t["trace_id"] for t in json.loads(body)["traces"]] == [tid]
    assert json.loads(_get(url, "/traces?slow_ms=60000")[1])["traces"] == []
    assert len(json.loads(_get(url, "/traces?n=2")[1])["traces"]) == 2
    status, body = _get(url, "/traces?format=jsonl&n=3")
    lines = body.decode().splitlines()
    assert status == 200 and len(lines) == 3
    assert all(json.loads(line)["trace_id"] for line in lines)
    assert _get(url, "/traces?slow_ms=junk")[0] == 400
    assert _get(url, "/traces?format=xml")[0] == 400


def _annotated(engine, recorder):
    """``[(event name, admission route), ...]`` of each span on one
    workload: plain, long (piecewise with ``prefill_chunk``) and
    batched admissions, a cancel."""
    rng = np.random.default_rng(0)
    spans = []
    rids = []
    for n, m in [(12, 8), (12, 4), (40, 6), (5, 9), (7, 30)]:
        sp = recorder.start_span("serve.request")
        spans.append(sp)
        rids.append(engine.submit(rng.integers(1, 259, n), max_new_tokens=m,
                                  span=sp))
    engine.step()
    engine.cancel(rids[-1])
    list(engine.run_until_drained())
    out = []
    for sp in spans:
        sp.finish()
        out.append([(e["name"], e.get("route"), e.get("outcome"))
                    for e in sp.events])
    return out


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 32},
                                {"pipeline_depth": 1}],
                         ids=["plain", "chunked", "depth1"])
def test_engine_annotations_equal_the_jax_engines(models, kw):
    jmodel, params, tmodel, _ = models
    kw = dict(num_slots=2, chunk=4, **kw)
    want = _annotated(JaxEngine(jmodel, params, **kw), JaxRecorder(1.0))
    got = _annotated(ContinuousEngine(tmodel, **kw), TraceRecorder(1.0))
    assert got == want


def test_jax_router_carries_one_trace_into_a_torch_replica(served,
                                                           tmp_path):
    from pyspark_tf_gke_tpu.router.discovery import UP, Replica
    from pyspark_tf_gke_tpu.router.gateway import RouterServer

    server, url = served
    router = RouterServer([Replica(rid=url, base_url=url)], hedge=False,
                          affinity_tokens=0, registry=JaxRegistry(),
                          event_log=JaxEventLog(str(tmp_path / "ev.jsonl")),
                          trace_sample=1.0)
    router.replicas.set_state(url, UP, load={})
    span = router.tracer.start_span("router.request")
    status, out, _ = router.route_json(
        "/v1/generate", {"prompts": ["routed"], "max_new_tokens": 4},
        span=span)
    span.finish()
    assert status == 200 and out["completions"][0]["new_tokens"] == 4
    [trace] = _wait_trace(server.tracer, span.trace_id)
    assert trace["spans"][0]["parent_id"] is not None
    [rt] = router.tracer.traces(trace_id=span.trace_id)
    assert "route" in [e["name"] for s in rt["spans"] for e in s["events"]]


def test_jax_extract_and_check_traces_accept_a_torch_export(models):
    """``GET /traces?format=jsonl`` of a torch replica: the JAX replay
    extractor turns it into a spec with one request a served request
    and their shapes, and ``check_traces`` finds one verdict a span."""
    server = BundleServer(models[3], device="cpu", continuous_slots=2,
                          continuous_chunk=4, trace_sample=1.0,
                          registry=MetricsRegistry())
    httpd, url = _start(server)
    try:
        shapes = [(5, 6), (17, 3), (9, 12)]
        for n, m in shapes:
            assert _post(url, {"prompts": ["y" * n], "max_new_tokens": m,
                               "deadline_ms": 60000})[0] == 200
        time.sleep(0.1)
        status, body = _get(url, "/traces?format=jsonl")
        assert status == 200
        traces = parse_traces(body)
        assert len(traces) == 3
        audit = check_traces(body)
        assert audit["ok"] and audit["request_spans"] == 3, audit
        spec = spec_from_traces(traces)
        got = sorted((r.prompt_tokens, r.output_tokens)
                     for r in spec.requests)
        assert got == sorted(shapes)
        assert all(r.deadline_ms == 60000 for r in spec.requests)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
