"""PyTorch port, request lifecycle: deadlines, streams and the replica's
HTTP contract, held against the JAX package (f32 on the CPU, weights
carried across with ``params_from_flax``).

The engine expires a queued request before admission, cancels an
in-slot one at a chunk boundary (decode-ahead depths 0 and 1, the page
audit of ``tests/test_radix_cache.py`` after every step) and drops a
piecewise admission with its pages, as the JAX engine does; a
nonpositive deadline raises in both; the queue introspection agrees;
``on_tokens`` receives the JAX engine's token groups (depths 0 and 1,
eos, speculative chunks). Over HTTP the port's server answers 504 for a
dead deadline, 429 with ``Retry-After`` past ``max_queue_depth``, 503
while draining, fails a parked waiter at shutdown, and serves ``/loadz``
with the JAX server's key set, ``/livez`` and ``/stepz``; a stream's SSE
events equal the JAX server's.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.train import continuous as jcont
from pyspark_tf_gke_tpu.train import serve as jserve
from pyspark_tf_gke_tpu_torch.train import continuous as tcont
from pyspark_tf_gke_tpu_torch.train import serve as tserve
from tests.test_radix_cache import _check_page_invariants
from tests.test_torch_engine import _models
from tests.test_torch_serve import bundles  # noqa: F401 — a fixture
from tests.test_torch_spec import K, TARGET, _pair, _prompt

torch.set_num_threads(1)

# the /loadz contract (tests/test_serve.py test_loadz_snapshot_key_stability)
LOADZ_KEYS = {"queued", "queued_tokens", "active", "slots_total",
              "kv_pages_free", "inflight_http", "draining",
              "bundle_generation", "prefix_cache_pages", "prefix_hit_rate",
              "capacity_free", "queue_delay_ms", "tenants",
              "spec_accept_rate", "step_host_overhead_frac",
              "step_tokens_per_sec", "role"}


@pytest.fixture(scope="module")
def lm():
    return _models(num_pages=32)


def _engines(lm, **kw):
    jmodel, params, tmodel = lm
    return (jcont.ContinuousEngine(jmodel, params, **kw),
            tcont.ContinuousEngine(tmodel, **kw))


# -- deadlines in the engine ----------------------------------------------------


def test_queued_request_expires_before_admission(lm):
    outs = []
    for eng in _engines(lm, num_slots=1, chunk=2):
        rid = eng.submit([1, 2, 3], max_new_tokens=8, deadline_s=0.005)
        keep = eng.submit([4, 5], max_new_tokens=3)
        time.sleep(0.02)
        out = eng.step()
        st = eng.stats
        outs.append(([(r.rid, r.expired, r.done, r.tokens) for r in out],
                     st["active"], st["solo_admits"], st["queued"],
                     st["deadline_expired"]))
        done = dict(eng.run_until_drained())
        assert len(done[keep]) == 3 and rid not in done
    assert outs[0] == outs[1]
    assert outs[1][0] == [(0, True, True, [])]


@pytest.mark.parametrize("depth", [0, 1])
def test_in_slot_request_is_cancelled_at_a_chunk_boundary(lm, depth):
    """A slow stream consumer paces the loop, so the 60-token budget
    cannot finish inside the deadline: the request leaves its slot
    part-decoded, its pages return (the audit holds after every step,
    with a chunk in flight at depth 1) and the engine serves on."""
    _, _, tmodel = lm
    eng = tcont.ContinuousEngine(tmodel, num_slots=1, chunk=1,
                                 pipeline_depth=depth)
    rid = eng.submit([1, 2, 3], max_new_tokens=60, deadline_s=0.05,
                     on_tokens=lambda toks: time.sleep(0.005))
    out = []
    while eng.busy:
        out += eng.step()
        _check_page_invariants(eng)
    req = next(r for r in out if r.rid == rid)
    assert req.expired and 0 < len(req.tokens) < 60
    st = eng.stats
    assert st["active"] == 0 and st["deadline_expired"] == 1
    assert st["paged"]["pages_in_use"] == 0
    r2 = eng.submit([1, 2, 3], max_new_tokens=4)
    assert len(dict(eng.run_until_drained())[r2]) == 4


def test_piecewise_admission_expires_with_its_pages(lm):
    """A 100-token prompt admitting in pieces of 32 expires after its
    first piece: both engines drop it, return its pages and finish the
    other request with the same tokens."""
    outs = []
    for eng in _engines(lm, num_slots=2, chunk=2, prefill_chunk=32):
        rng = np.random.default_rng(5)
        other = eng.submit(rng.integers(1, 97, 6), max_new_tokens=6)
        long_ = eng.submit(rng.integers(1, 97, 100), max_new_tokens=4,
                           deadline_s=60.0)
        steps = 0
        while eng._admitting is None or eng._admitting["req"].rid != long_:
            eng.step()
            steps += 1
        eng._admitting["req"].deadline = time.monotonic() - 1.0
        expired = [r.rid for r in eng.step() if r.expired]
        done = dict(eng.run_until_drained())
        st = eng.stats
        outs.append((steps, expired, done[other], st["deadline_expired"],
                     st["paged"]["pages_in_use"]))
    assert outs[0] == outs[1]
    assert outs[1][1] == [1] and outs[1][4] == 0


def test_nonpositive_deadline_raises_in_both(lm):
    for eng in _engines(lm, num_slots=1, chunk=1):
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit([1, 2], max_new_tokens=4, deadline_s=0.0)


def test_queue_introspection_matches_jax(lm):
    got = []
    for eng in _engines(lm, num_slots=1, chunk=2,
                        tenant_weights={"a": 2}):
        eng.submit([1, 2, 3], max_new_tokens=10)
        eng.submit([1, 2], max_new_tokens=5, tenant="a")
        eng.submit([4], max_new_tokens=7, tenant="a")
        st = eng.stats
        got.append((eng.queue_depth(), eng.queue_depth("a"),
                     eng.queued_tokens(), eng.queued_tokens("a"),
                     st["queued_tokens"], st["tenants"], st["fair_active"],
                     eng.queue_delay_ms() > 0))
        list(eng.run_until_drained())
        assert eng.queue_delay_ms() == 0.0
    assert got[0] == got[1]
    assert got[1][:5] == (3, 2, 28, 15, 28)


# -- on_tokens: the token groups ------------------------------------------------


def _groups(engine, waves):
    """Submit each wave two steps after the previous one, every request
    with an ``on_tokens`` recorder; drain. Returns each request's groups
    and final tokens, in submit order."""
    groups, rids, done = [], [], {}

    def submit(p, m):
        mine = []
        groups.append(mine)
        rids.append(engine.submit(p, max_new_tokens=m,
                                  on_tokens=lambda t: mine.append(list(t))))

    for i, wave in enumerate(waves):
        for p, m in wave:
            submit(p, m)
        for _ in range(2 if i + 1 < len(waves) else 0):
            done.update((r.rid, r.tokens) for r in engine.step())
    done.update(engine.run_until_drained())
    return groups, [list(done[r]) for r in rids]


def _waves(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(1, vocab, n), m) for n, m in [(5, 9), (12, 4)]],
            [(rng.integers(1, vocab, n), m) for n, m in [(7, 11)]]]


@pytest.mark.parametrize("depth,eos", [(0, False), (1, False), (1, True)])
def test_on_tokens_groups_match_jax(lm, depth, eos):
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32), pipeline_depth=depth)
    if eos:
        plain = _groups(_engines(lm, **kw)[0], _waves(97))[1]
        kw["eos_token_id"] = plain[0][4]
    (jg, jt), (tg, tt) = (_groups(eng, _waves(97))
                          for eng in _engines(lm, **kw))
    assert tg == jg and tt == jt
    for groups, toks in zip(tg, tt):
        assert [t for g in groups for t in g] == toks
    assert max(len(g) for g in tg) >= 2  # chunked delivery


def test_on_tokens_groups_under_spec_tokens_match_jax():
    _, jpaged, params, _, tpaged = _pair(TARGET, 0)
    kw = dict(num_slots=2, chunk=6, buckets=(16, 32), spec_tokens=K,
              pipeline_depth=1)
    rng = np.random.default_rng(9)
    waves = [[(_prompt(rng, 5), 12), (_prompt(rng, 11), 7)],
             [(_prompt(rng, 8), 10)]]
    jg, jt = _groups(jcont.ContinuousEngine(jpaged, params, **kw), waves)
    tg, tt = _groups(tcont.ContinuousEngine(tpaged, **kw), waves)
    assert tg == jg and tt == jt


def test_a_raising_consumer_does_not_stop_the_engine(lm):
    _, _, tmodel = lm
    eng = tcont.ContinuousEngine(tmodel, num_slots=2, chunk=2)

    def boom(toks):
        raise RuntimeError("consumer gone")

    bad = eng.submit([1, 2, 3], max_new_tokens=5, on_tokens=boom)
    good = eng.submit([4, 5], max_new_tokens=5)
    done = dict(eng.run_until_drained())
    assert len(done[bad]) == 5 and len(done[good]) == 5


def test_pipelined_stream_groups_arrive_in_order(lm):
    """The front at decode-ahead depth 1: a stream's groups arrive in
    generation order, the terminal ``[]`` strictly last, and the tokens
    are the JAX engine's."""
    jmodel, params, tmodel = lm
    front = tserve._ContinuousFront(tmodel, num_slots=2, chunk=2,
                                    pipeline_depth=1)
    try:
        rid, q = front.submit_stream([1, 2, 3], 12)
        groups = []
        while True:
            item = q.get(timeout=120)
            assert not isinstance(item, Exception), item
            if item == []:
                break
            groups.append(list(item))
        assert q.empty() and len(groups) >= 2
        assert front.wait(rid, timeout_s=10) == [t for g in groups
                                                 for t in g]
    finally:
        front.shutdown()
    jeng = jcont.ContinuousEngine(jmodel, params, num_slots=2, chunk=2,
                                  pipeline_depth=1)
    jrid = jeng.submit([1, 2, 3], 12)
    assert dict(jeng.run_until_drained())[jrid] == [t for g in groups
                                                    for t in g]


# -- over HTTP ------------------------------------------------------------------


def _start(server):
    httpd = tserve.start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, thread, server):
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(10)


def _call(url, path, body=None, headers=None):
    """``(status, headers, json body)`` of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, err.headers, json.loads(err.read())


def _sse(url, body):
    """A stream's ``data:`` payloads, parsed (``[DONE]`` kept as is)."""
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        raw = resp.read().decode()
    # the JAX server opens with a ": trace_id=" comment (request
    # tracing, not ported): comments are not events
    events = [chunk for chunk in raw.split("\n\n")
              if chunk and not chunk.startswith(":")]
    assert all(e.startswith("data: ") for e in events), raw
    return [e[6:] if e[6:] == "[DONE]" else json.loads(e[6:])
            for e in events]


@pytest.fixture(scope="module")
def served(bundles):  # noqa: F811
    _, _, tdir = bundles
    server = tserve.BundleServer(tdir, device="cpu", continuous_slots=2,
                                 continuous_chunk=2)
    httpd, thread, url = _start(server)
    yield url, server
    _stop(httpd, thread, server)


def test_http_deadline_maps_to_504(served):
    url, _ = served
    assert _call(url, "/v1/generate", {"prompts": ["abc"],
                                       "max_new_tokens": 2})[0] == 200
    status, _, body = _call(url, "/v1/generate", {
        "prompts": ["abc"], "max_new_tokens": 50, "deadline_ms": 1})
    assert status == 504 and "deadline" in body["error"]
    status, _, body = _call(url, "/v1/generate", {
        "prompt": "abc", "stream": True, "max_new_tokens": 8,
        "deadline_ms": 0})
    assert status == 504 and "deadline" in body["error"]


def test_loadz_key_set_livez_and_stepz(bundles, served):  # noqa: F811
    url, _ = served
    _, _, tdir = bundles
    assert _call(url, "/v1/generate", {"prompts": ["ab"],
                                       "max_new_tokens": 2})[0] == 200
    status, _, load = _call(url, "/loadz")
    assert status == 200 and set(load) == LOADZ_KEYS
    assert load["role"] == "mixed" and load["slots_total"] == 2
    assert load["kv_pages_free"] == 32 and load["bundle_generation"] == 1
    jserver = jserve.BundleServer(str(Path(tdir).parent / "jax"),
                                  continuous_slots=2, continuous_chunk=2)
    try:
        jload = jserver.loadz()
    finally:
        jserver._front.shutdown()
    assert set(jload) == set(load)
    same = ("queued", "queued_tokens", "active", "slots_total",
            "kv_pages_free", "capacity_free", "role", "draining",
            "bundle_generation", "spec_accept_rate")
    assert {k: load[k] for k in same} == {k: jload[k] for k in same}
    status, _, live = _call(url, "/livez")
    assert status == 200 and live["live"] and not live["draining"]
    assert live["driver_loop_age_s"] < 5
    status, _, stepz = _call(url, "/stepz?n=2")
    assert status == 200 and stepz["summary"]["records"] >= 1
    assert 1 <= len(stepz["steps"]) <= 2
    assert {"seq", "wall_ms", "phases_ms"} <= set(stepz["steps"][0])
    assert _call(url, "/stepz?n=x")[0] == 400


def test_sse_framing_matches_the_jax_server(bundles, served):  # noqa: F811
    url, _ = served
    _, _, tdir = bundles
    body = {"prompt": "stream me", "stream": True, "max_new_tokens": 9}
    got = _sse(url, body)
    jserver = jserve.BundleServer(str(Path(tdir).parent / "jax"),
                                  continuous_slots=2, continuous_chunk=2)
    httpd = jserve.start_http_server(jserver, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        want = _sse(f"http://127.0.0.1:{httpd.server_address[1]}", body)
    finally:
        httpd.shutdown()
        jserver._front.shutdown()
    for events in (got, want):
        assert events[-1] == "[DONE]" and events[-2]["done"]
        events[-2].pop("latency_ms")
    assert got == want
    assert got[-2]["new_tokens"] == sum(len(e["token_ids"])
                                        for e in got[:-2])
    # the body is validated before the status line
    status, _, err = _call(url, "/v1/generate", {
        "prompt": "x", "stream": True, "continuation": {"emitted_ids": []}})
    assert status == 400 and "continuation" in err["error"]
    status, _, err = _call(url, "/v1/generate", {
        "prompt": "x", "stream": True, "temperature": 0.5})
    assert status == 400 and "greedy" in err["error"]


def test_http_queue_full_429_then_shutdown_fails_the_waiter(bundles):  # noqa: F811,E501
    _, _, tdir = bundles
    server = tserve.BundleServer(tdir, device="cpu", continuous_slots=1,
                                 continuous_chunk=2, max_queue_depth=1)
    httpd, thread, url = _start(server)
    front = server._front
    # park the driver so the first request deterministically queues
    front.stop.set()
    front.new_work.set()
    front.thread.join(timeout=10)
    outcome = {}

    def blocked_client():
        outcome["a"] = _call(url, "/v1/generate",
                             {"prompts": ["aa"], "max_new_tokens": 4})[0]

    t = threading.Thread(target=blocked_client)
    t.start()
    try:
        deadline = time.time() + 10
        while front.engine.queue_depth() < 1 and time.time() < deadline:
            time.sleep(0.02)
        status, headers, body = _call(url, "/v1/generate",
                                      {"prompts": ["bb"],
                                       "max_new_tokens": 4})
        assert status == 429 and headers["Retry-After"] == "1"
        assert body["reason"] == "queue_full"
        assert _call(url, "/loadz")[2]["queued"] == 1
    finally:
        front.shutdown()  # the parked waiter fails now: a 500, no hang
        t.join(timeout=30)
        _stop(httpd, thread, server)
    assert not t.is_alive() and outcome["a"] == 500


def test_http_drain_lifecycle(bundles):  # noqa: F811
    _, _, tdir = bundles
    server = tserve.BundleServer(tdir, device="cpu", continuous_slots=2,
                                 continuous_chunk=2)
    httpd, thread, url = _start(server)
    try:
        status, _, out = _call(url, "/v1/generate", {"prompts": ["hi"],
                                                     "max_new_tokens": 3})
        assert status == 200 and out["completions"][0]["new_tokens"] == 3
        assert _call(url, "/healthz")[2]["status"] == "ok"
        server.begin_drain()
        status, _, health = _call(url, "/healthz")
        assert status == 503 and health["status"] == "draining"
        status, headers, body = _call(url, "/v1/generate", {
            "prompts": ["no"], "max_new_tokens": 3})
        assert status == 503 and headers["Retry-After"] == "5"
        assert body["reason"] == "draining"
        assert _call(url, "/loadz")[2]["draining"] is True
        status, _, live = _call(url, "/livez")
        assert status == 200 and live["live"] and live["draining"]
        assert server.drain(timeout_s=10)
        with pytest.raises(tserve.RequestRejected) as e:
            server.generate(["x"], max_new_tokens=2)
        assert e.value.status == 503
    finally:
        _stop(httpd, thread, server)
