"""PyTorch port, bundle hot swap (``reload_bundle`` / ``POST
/admin/reload``): the cases of ``tests/test_hot_swap.py`` on a torch
server with bundles the JAX package exported and the port converted.
The advertised ``bundle_generation`` advances only after a swap and its
canary; a corrupt or incompatible bundle leaves the old generation
serving; reloads serialize (409) and are token-gated; a swap landing
mid-stream gives the stream one explicit terminal. Greedy tokens after a
swap equal the JAX server's on the swapped-in bundle, and the JAX
package's ``pipeline.publish.reload_replica`` rolls a torch replica.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from pyspark_tf_gke_tpu.train import export as jexport
from pyspark_tf_gke_tpu.train import serve as jserve
from pyspark_tf_gke_tpu_torch.obs.events import EventLog
from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
from pyspark_tf_gke_tpu_torch.train import export as texport
from pyspark_tf_gke_tpu_torch.train.serve import (BundleReloadError,
                                                  BundleServer,
                                                  ReloadInFlight,
                                                  RequestRejected,
                                                  start_http_server)

torch.set_num_threads(1)

CFG = dict(vocab_size=259, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_seq_len=64, dtype=jnp.float32,
           kv_page_size=16, kv_num_pages=24)
TOKEN = "test-admin-token"


def _export(tmp, name, seed, generation, overrides=None):
    """``(jax_dir, torch_dir)``: a JAX export and its conversion."""
    cfg = CausalLMConfig(**{**CFG, **(overrides or {})})
    model = CausalLM(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(seed),
                                      jnp.zeros((1, 8), jnp.int32))["params"])
    meta = {"pipeline_generation": generation}
    jdir = jexport.export_serving_bundle(cfg, params, str(tmp / f"{name}-j"),
                                         quantize=False, extra_meta=meta)
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tdir = texport.export_serving_bundle(
        texport.config_from_dict(fields),
        texport.params_from_flax(jax.device_get(params)),
        str(tmp / f"{name}-t"), quantize=False, extra_meta=meta)
    return jdir, tdir


def _serve(server):
    httpd = start_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def swap_env(tmp_path_factory):
    """A torch server on bundle A (generation 1) with 2 slots; B has the
    same shape and other weights (generation 2); V another vocabulary;
    a corrupt bundle."""
    tmp = tmp_path_factory.mktemp("torch-hot-swap")
    a = _export(tmp, "A", seed=0, generation=1)
    b = _export(tmp, "B", seed=7, generation=2)
    v = _export(tmp, "V", seed=1, generation=3, overrides={"vocab_size": 300})
    corrupt = tmp / "corrupt"
    corrupt.mkdir()
    (corrupt / "config.json").write_text("{definitely not json")
    server = BundleServer(a[1], device="cpu", continuous_slots=2,
                          continuous_chunk=2, prefix_cache_size=2,
                          admin_token=TOKEN, registry=MetricsRegistry(),
                          event_log=EventLog(str(tmp / "events.jsonl")))
    httpd, url = _serve(server)
    yield {"server": server, "url": url, "tmp": tmp,
           "bundles": {"a": a[1], "b": b[1], "vocab": v[1],
                       "corrupt": str(corrupt)},
           "jax": {"a": a[0], "b": b[0]}}
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()


def _post(url, path, payload, token=None):
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["X-Admin-Token"] = token
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as resp:
        return json.loads(resp.read())


def _completion(url, prompt, n=8):
    code, body = _post(url, "/v1/generate",
                       {"prompts": [prompt], "max_new_tokens": n})
    assert code == 200, body
    return body["completions"][0]["completion"]


def _reinstall(env, key, generation):
    env["server"].reload_bundle(env["bundles"][key], generation=generation)
    assert env["server"].bundle_generation == generation


def test_loadz_and_healthz_carry_generation(swap_env):
    load = _get(swap_env["url"], "/loadz")
    health = _get(swap_env["url"], "/healthz")
    assert load["bundle_generation"] == health["bundle_generation"] >= 1


def test_admin_reload_token_gate(swap_env):
    url, bundles = swap_env["url"], swap_env["bundles"]
    assert _post(url, "/admin/reload", {"bundle": bundles["b"]})[0] == 401
    assert _post(url, "/admin/reload", {"bundle": bundles["b"]},
                 token="wrong")[0] == 401
    assert (_get(url, "/loadz")["bundle_generation"]
            == swap_env["server"].bundle_generation)


def test_admin_reload_disabled_without_token_config(swap_env):
    """No admin token on the server: 403 on both admin endpoints, as the
    JAX server answers."""
    server = BundleServer(swap_env["bundles"]["a"], device="cpu",
                          registry=MetricsRegistry())
    httpd, url = _serve(server)
    try:
        for path in ("/admin/reload", "/admin/profile"):
            code, body = _post(url, path, {"bundle": "x"}, token="anything")
            assert code == 403 and "disabled" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_swap_serves_new_weights_and_regresses_nothing_stale(swap_env):
    """After a swap the next generate gives bundle B's tokens, equal to
    the JAX server's on B; generation, meta and bundle path follow."""
    url, server = swap_env["url"], swap_env["server"]
    _reinstall(swap_env, "a", 1)
    out_a = _completion(url, "hello swap")
    code, body = _post(url, "/admin/reload",
                       {"bundle": swap_env["bundles"]["b"]}, token=TOKEN)
    assert code == 200 and body["ok"] and body["bundle_generation"] == 2
    assert set(body["timings_s"]) == {"load", "swap", "canary"}
    out_b = _completion(url, "hello swap")
    assert out_b != out_a
    jserver = jserve.BundleServer(swap_env["jax"]["b"],
                                  registry=JaxRegistry())
    want = jserver.generate(["hello swap"], max_new_tokens=8)[0]
    assert out_b == want["completion"]
    assert _get(url, "/loadz")["bundle_generation"] == 2
    assert _get(url, "/healthz")["bundle_generation"] == 2
    assert server.meta.get("pipeline_generation") == 2
    assert server.bundle_dir == swap_env["bundles"]["b"]


def test_corrupt_bundle_leaves_old_generation_serving(swap_env):
    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    before = _completion(url, "stability")
    code, body = _post(url, "/admin/reload",
                       {"bundle": swap_env["bundles"]["corrupt"]},
                       token=TOKEN)
    assert code == 502 and body["rolled_back"] is False
    assert body["bundle_generation"] == 1
    assert _get(url, "/loadz")["bundle_generation"] == 1
    assert _completion(url, "stability") == before


def test_incompatible_vocab_rejected(swap_env):
    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    code, body = _post(url, "/admin/reload",
                       {"bundle": swap_env["bundles"]["vocab"]}, token=TOKEN)
    assert code == 502 and "vocab" in body["error"]
    assert _get(url, "/loadz")["bundle_generation"] == 1


def test_canary_failure_rolls_back_to_previous_bundle(swap_env):
    url, server = swap_env["url"], swap_env["server"]
    _reinstall(swap_env, "a", 1)
    before = _completion(url, "canary check")
    orig = server._canary
    server._canary = lambda: (_ for _ in ()).throw(
        RuntimeError("canary exploded"))
    try:
        with pytest.raises(BundleReloadError) as ei:
            server.reload_bundle(swap_env["bundles"]["b"])
        assert ei.value.rolled_back is True
    finally:
        server._canary = orig
    assert server.bundle_generation == 1
    assert _get(url, "/loadz")["bundle_generation"] == 1
    assert server.bundle_dir == swap_env["bundles"]["a"]
    assert _completion(url, "canary check") == before


def test_canary_that_raises_in_the_engine_rolls_back(swap_env):
    """The canary's admission fails (the ``engine.admit`` chaos point):
    the engine step raises, the canary's waiter gets the error, the
    previous bundle is reinstalled and serves."""
    from pyspark_tf_gke_tpu_torch.chaos import inject

    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    before = _completion(url, "engine canary")
    inject.install(inject.ChaosInjector.from_spec("engine.admit:fail@1"))
    try:
        code, body = _post(url, "/admin/reload",
                           {"bundle": swap_env["bundles"]["b"]}, token=TOKEN)
    finally:
        inject.uninstall()
    assert code == 502 and body["rolled_back"] is True
    assert body["bundle_generation"] == 1
    assert _completion(url, "engine canary") == before


def test_second_reload_conflicts_409(swap_env):
    url, server = swap_env["url"], swap_env["server"]
    assert server._reload_lock.acquire(blocking=False)
    try:
        code, _ = _post(url, "/admin/reload",
                        {"bundle": swap_env["bundles"]["b"]}, token=TOKEN)
        assert code == 409
        with pytest.raises(ReloadInFlight):
            server.reload_bundle(swap_env["bundles"]["b"])
    finally:
        server._reload_lock.release()


def test_swap_mid_stream_reaches_explicit_terminal(swap_env):
    """A swap landing while a stream decodes: the old engine is drained
    inside the swap, the stream ends with its terminal and ``[DONE]``,
    and the next request serves generation 2."""
    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    events, done = [], threading.Event()

    def stream():
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": "mid-stream swap ",
                             "max_new_tokens": 40,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                for raw in resp:
                    line = raw.strip()
                    if line.startswith(b"data: "):
                        events.append(line[6:].decode())
        finally:
            done.set()

    t = threading.Thread(target=stream)
    t.start()
    t0 = time.monotonic()
    while not events and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    assert events, "stream never started"
    code, body = _post(url, "/admin/reload",
                       {"bundle": swap_env["bundles"]["b"]}, token=TOKEN)
    assert code == 200, body
    assert done.wait(60), "the stream hung through the swap"
    t.join()
    assert events[-1] == "[DONE]"
    bodies = [json.loads(e) for e in events[:-1]]
    terminals = [b for b in bodies if b.get("done") or b.get("error")]
    assert len(terminals) == 1, events
    assert _get(url, "/loadz")["bundle_generation"] == 2
    _completion(url, "after the swap")


def test_warmed_prefixes_dropped_on_swap(swap_env):
    server = swap_env["server"]
    _reinstall(swap_env, "a", 1)
    server.warm_prefix("a shared prefix for the cache")
    assert server._front._warmed
    _reinstall(swap_env, "b", 2)
    assert server._front._warmed == []


def test_malformed_generation_rejected_before_any_swap(swap_env):
    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    before = _completion(url, "gen guard")
    code, _ = _post(url, "/admin/reload",
                    {"bundle": swap_env["bundles"]["b"],
                     "generation": "oops"}, token=TOKEN)
    assert code == 400
    assert _get(url, "/loadz")["bundle_generation"] == 1
    assert _completion(url, "gen guard") == before


def test_canary_bypasses_admission_gates(swap_env, monkeypatch):
    server = swap_env["server"]
    _reinstall(swap_env, "a", 1)

    def shed(*a, **k):
        raise RequestRejected("queue_full", "synthetic overload", status=429)

    monkeypatch.setattr(server._front, "_check_admission", shed)
    out = server.reload_bundle(swap_env["bundles"]["b"], generation=2)
    assert out["ok"] and out["bundle_generation"] == 2


def test_reload_events_and_metrics(swap_env):
    """The reload's trail (started, succeeded / failed) and its outcome
    counter, as the JAX server emits them."""
    url, server = swap_env["url"], swap_env["server"]
    _reinstall(swap_env, "a", 1)
    _post(url, "/admin/reload", {"bundle": swap_env["bundles"]["corrupt"]},
          token=TOKEN)
    kinds = [e["kind"] for e in server.event_log.tail(50)]
    assert "bundle_reload_started" in kinds
    assert "bundle_reload_succeeded" in kinds
    assert kinds[-1] == "bundle_reload_failed"
    text = server.metrics_text()
    assert 'serve_bundle_reloads_total{outcome="ok"}' in text
    assert 'serve_bundle_reloads_total{outcome="rejected"}' in text
    assert "serve_bundle_generation 1" in text


def test_jax_publish_rolls_a_torch_replica(swap_env):
    """The JAX pipeline's publish client against a torch replica: one
    reload to generation 2, confirmed on ``/loadz``."""
    from pyspark_tf_gke_tpu.pipeline.publish import (confirm_generation,
                                                     reload_replica,
                                                     rolling_publish)

    url = swap_env["url"]
    _reinstall(swap_env, "a", 1)
    out = reload_replica(url, swap_env["bundles"]["b"], 2, token=TOKEN)
    assert out["ok"] and out["status"] == 200
    assert out["body"]["bundle_generation"] == 2
    assert confirm_generation(url, 2, timeout_s=10)
    res = rolling_publish([url], swap_env["bundles"]["a"], 3, token=TOKEN,
                          confirm_timeout_s=10)
    assert res["ok"] and res["published"] == 1
    assert _get(url, "/loadz")["bundle_generation"] == 3
