"""PyTorch port, fleet contract: the JAX package's reference router
(``router/gateway.py`` ``RouterServer``, run in this process) in front
of the port's replica, alone and beside a JAX replica, on one exported
bundle (f32 activations, int8 weights; the torch bundle converted from
the JAX one).

Greedy completions through the router equal the JAX package's
``generate`` whichever replica serves; a stream whose first leg is cut
after a few events (a relay in front of one replica that forwards its
first events and drops the connection, as
``tests/test_stream_failover.py``'s stubs do) is continued by the other
package's replica token for token, in both directions; a disaggregated
prefill (``disagg_min_prompt``) crosses packages both ways, the decode
replica prefilling only the tail past the imported pages, with the
tokens of the run without a handoff.
"""

import http.client
import json
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from pyspark_tf_gke_tpu.obs.events import EventLog
from pyspark_tf_gke_tpu.obs.metrics import MetricsRegistry
from pyspark_tf_gke_tpu.router.discovery import HealthProber, Replica
from pyspark_tf_gke_tpu.router.gateway import (RouterServer,
                                               start_router_http_server)
from pyspark_tf_gke_tpu.train import serve as jserve
from pyspark_tf_gke_tpu_torch.train import serve as tserve
from tests.test_torch_serve import _jax_completion
from tests.test_torch_serve import bundles  # noqa: F401 — a fixture

torch.set_num_threads(1)

PROMPTS = ["hello", "paged attention on hopper", "xyz", "fleet of two",
           "router in front"]


def _serve(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def fleet(bundles):  # noqa: F811
    """One JAX and one torch replica of the same bundle, each with the
    radix cache (the disaggregated handoff needs it); their ``role`` is
    set per test."""
    jmodel, jparams, tdir = bundles
    kw = dict(continuous_slots=2, continuous_chunk=2, prefix_cache_size=16)
    servers = {
        "jax": jserve.BundleServer(str(Path(tdir).parent / "jax"),
                                   registry=MetricsRegistry(), **kw),
        "torch": tserve.BundleServer(tdir, device="cpu", **kw)}
    httpds = {"jax": jserve.start_http_server(servers["jax"], "127.0.0.1",
                                              0),
              "torch": tserve.start_http_server(servers["torch"],
                                                "127.0.0.1", 0)}
    urls = {k: _serve(h) for k, h in httpds.items()}
    yield {"servers": servers, "urls": urls,
           "ref": lambda p, n: _jax_completion(jmodel, jparams, p, n)[0]}
    for h in httpds.values():
        h.shutdown()
        h.server_close()
    servers["jax"]._front.shutdown()
    servers["torch"].shutdown()


def _router(tmp_path, replicas, **kw):
    """A router over ``[(rid, url), ...]`` (ties break on the rid) with
    one probe sweep done; returns ``(router, httpd, url)``."""
    router = RouterServer(
        [Replica(rid=rid, base_url=url) for rid, url in replicas],
        registry=MetricsRegistry(),
        event_log=EventLog(str(tmp_path / "events.jsonl")),
        request_timeout_s=120.0, affinity_tokens=0, hedge=False, **kw)
    HealthProber(router.replicas, interval_s=999,
                 fail_threshold=1).probe_once()
    httpd = start_router_http_server(router, host="127.0.0.1", port=0)
    return router, httpd, _serve(httpd)


def _post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _stream(url, body):
    """A stream's ``data:`` payloads, parsed, and whether ``[DONE]``
    closed it."""
    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                      timeout=120)
    conn.request("POST", "/v1/generate", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, done = [], False
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            break
        events.append(json.loads(line[6:]))
    conn.close()
    return events, done


class CutRelay:
    """Stands in front of one replica: probes and plain requests pass
    through; a stream forwards the replica's first ``cut_after`` events
    and then drops the connection without ``[DONE]`` (a replica dying
    mid-stream). Records the requests it saw."""

    def __init__(self, upstream: str, cut_after: int):
        self.upstream = urllib.parse.urlsplit(upstream)
        self.cut_after = cut_after
        self.received = []
        relay = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _upstream(self, method, body=None):
                conn = http.client.HTTPConnection(
                    relay.upstream.hostname, relay.upstream.port,
                    timeout=120)
                conn.request(method, self.path, body=body, headers={
                    "Content-Type": "application/json"})
                return conn, conn.getresponse()

            def _relay_whole(self, conn, resp):
                data = resp.read()
                conn.close()
                self.send_response(resp.status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._relay_whole(*self._upstream("GET"))

            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                req = json.loads(body)
                relay.received.append(req)
                conn, resp = self._upstream("POST", body)
                if not req.get("stream") or resp.status != 200:
                    return self._relay_whole(conn, resp)
                self.close_connection = True
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Connection", "close")
                self.end_headers()
                sent = 0
                for raw in resp:
                    if raw.startswith(b"data: ") and sent == relay.cut_after:
                        break  # the cut: no more events, no [DONE]
                    self.wfile.write(raw)
                    self.wfile.flush()
                    sent += raw.startswith(b"data: ")
                conn.close()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = _serve(self.httpd)

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _set_roles(fleet, roles):
    for name, role in roles.items():
        fleet["servers"][name].role = role


def test_router_in_front_of_a_torch_replica(fleet, tmp_path):
    _set_roles(fleet, {"jax": "mixed", "torch": "mixed"})
    router, httpd, url = _router(tmp_path, [("torch",
                                             fleet["urls"]["torch"])])
    try:
        assert router.replicas.get("torch").load["role"] == "mixed"
        for prompt in PROMPTS[:3]:
            out = _post(url, {"prompts": [prompt], "max_new_tokens": 12})
            assert out["completions"][0]["completion"] == fleet["ref"](
                prompt, 12)
        events, done = _stream(url, {"prompt": PROMPTS[3], "stream": True,
                                     "max_new_tokens": 10})
        assert done and events[-1]["completion"] == fleet["ref"](
            PROMPTS[3], 10)
    finally:
        httpd.shutdown()


def test_mixed_pair_gives_jax_tokens_whichever_serves(fleet, tmp_path):
    _set_roles(fleet, {"jax": "mixed", "torch": "mixed"})
    finished0 = {k: s.health()["continuous"]["finished"]
                 for k, s in fleet["servers"].items()}
    router, httpd, url = _router(tmp_path, [
        ("a-jax", fleet["urls"]["jax"]), ("b-torch", fleet["urls"]["torch"])])
    results = {}

    def client(i):
        prompt = PROMPTS[i % len(PROMPTS)] + f" {i}"
        results[i] = (prompt, _post(url, {"prompts": [prompt],
                                          "max_new_tokens": 10}))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        httpd.shutdown()
    assert len(results) == 8
    for prompt, out in results.values():
        assert out["completions"][0]["completion"] == fleet["ref"](prompt,
                                                                   10)
    served = {k: s.health()["continuous"]["finished"] - finished0[k]
              for k, s in fleet["servers"].items()}
    assert served["jax"] > 0 and served["torch"] > 0, served


@pytest.mark.parametrize("cut,cont", [("jax", "torch"), ("torch", "jax")])
def test_stream_cut_on_one_package_continues_on_the_other(fleet, tmp_path,
                                                          cut, cont):
    _set_roles(fleet, {"jax": "mixed", "torch": "mixed"})
    prompt, budget = f"splice {cut} to {cont}", 16
    want, done = _stream(fleet["urls"][cut], {"prompt": prompt,
                                              "stream": True,
                                              "max_new_tokens": budget})
    assert done
    want_ids = [t for e in want[:-1] for t in e["token_ids"]]
    relay = CutRelay(fleet["urls"][cut], cut_after=3)
    router, httpd, url = _router(tmp_path, [
        ("a-cut", relay.url), ("b-cont", fleet["urls"][cont])])
    try:
        events, done = _stream(url, {"prompt": prompt, "stream": True,
                                     "max_new_tokens": budget})
    finally:
        httpd.shutdown()
        relay.stop()
    assert done
    got_ids = [t for e in events[:-1] for t in e.get("token_ids", [])]
    assert not any("error" in e for e in events)
    assert got_ids == want_ids
    terminal = events[-1]
    assert terminal["done"] and terminal["resumed"]
    assert terminal["completion"] == want[-1]["completion"]
    assert terminal["new_tokens"] == want[-1]["new_tokens"]
    assert router._obs["router_stream_resumes_total"].labels(
        outcome="ok").value == 1
    assert relay.received[0].get("continuation") is None


@pytest.mark.parametrize("prefill,decode", [("jax", "torch"),
                                            ("torch", "jax")])
def test_disaggregated_prefill_crosses_packages(fleet, tmp_path, prefill,
                                                decode):
    """The router sends the long prompt's prefill to the prefill-role
    replica, ships its pages to the decode-role replica of the other
    package, which prefills only the 6 tokens past the imported 4 pages
    of 16 and gives the tokens of a run without a handoff."""
    _set_roles(fleet, {prefill: "prefill", decode: "decode"})
    prompt = f"disaggregated prefill from {prefill} into {decode}; "
    prompt = (prompt * 3)[:70]  # 70 bytes: 4 full pages and 6 tokens
    dec = fleet["servers"][decode]
    before = dec.health()["continuous"]["prefill_tokens_computed"]
    router, httpd, url = _router(
        tmp_path, [(prefill, fleet["urls"][prefill]),
                   (decode, fleet["urls"][decode])], disagg_min_prompt=64)
    try:
        out = _post(url, {"prompts": [prompt], "max_new_tokens": 8})
    finally:
        httpd.shutdown()
        _set_roles(fleet, {prefill: "mixed", decode: "mixed"})
    assert router._obs["router_kv_xfer_total"].labels(
        outcome="ok").value == 1
    after = dec.health()["continuous"]["prefill_tokens_computed"]
    assert after - before == 6
    assert out["completions"][0]["completion"] == fleet["ref"](prompt, 8)
