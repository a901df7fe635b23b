"""PyTorch port, serving: a quantized byte-tokenizer bundle exported by
the JAX package, converted with ``params_from_flax``, served by the
port's HTTP server on the CPU. ``/v1/generate`` greedy completions equal
the JAX package's ``generate`` on the same bundle; ``/v1/score`` NLLs
match JAX ``serve_score`` to a relative 1e-4 (f32 sums of ~30 per-token
NLLs of O(5) each, computed in another order).
"""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.train import export as jexport
from pyspark_tf_gke_tpu.train.serving import serve_score as jax_score
from pyspark_tf_gke_tpu_torch.train import export as texport
from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                  start_http_server)

torch.set_num_threads(1)

PROMPTS = ["hello", "paged attention on hopper", "xyz"]
EOS = 258


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundles")
    cfg = jlm.CausalLMConfig(
        vocab_size=259, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_seq_len=128, dtype=jnp.float32,
        kv_page_size=16, kv_num_pages=32)
    model = jlm.CausalLM(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(1),
                                      jnp.ones((1, 8), jnp.int32))["params"])
    jdir = jexport.export_serving_bundle(cfg, params, str(root / "jax"),
                                         quantize=True)
    # the conversion recipe: JAX load -> host numpy -> port export
    jmodel, jparams, meta = jexport.load_serving_bundle(jdir)
    jparams = jax.device_get(jparams)
    tdir = texport.export_serving_bundle(
        texport.config_from_dict(meta["config"]),
        texport.params_from_flax(jparams), str(root / "torch"))
    return jmodel, jparams, tdir


@pytest.fixture(scope="module")
def http(bundles):
    _, _, tdir = bundles
    server = BundleServer(tdir, device="cpu", continuous_slots=2,
                          continuous_chunk=4)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(10)
    assert not thread.is_alive()


def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _jax_completion(jmodel, jparams, prompt, max_new):
    ids = list(prompt.encode())
    out = jlm.generate(jmodel, jparams, jnp.asarray([ids], jnp.int32),
                       max_new_tokens=max_new, eos_token_id=EOS)
    new = np.asarray(out)[0, len(ids):].tolist()
    if EOS in new:
        new = new[:new.index(EOS)]
    return prompt + bytes(t for t in new if t < 256).decode(
        "utf-8", errors="replace"), len(new)


def test_bundle_roundtrip_keeps_int8_leaves(bundles):
    _, jparams, tdir = bundles
    model, params, meta = texport.load_serving_bundle(tdir, "cpu")
    assert meta["format"] == texport.FORMAT and meta["quantized"]
    head = params["lm_head/kernel"]  # >= 4096 elements: int8 per column
    np.testing.assert_array_equal(head.q.numpy(),
                                  np.asarray(jparams["lm_head"]["kernel"].q))
    assert head.scale.shape == (259,)
    assert params["wte/embedding"].scale.shape == (259, 1)  # per row
    assert isinstance(params["layer_0/attention/query/kernel"], torch.Tensor)


def test_healthz(http):
    status, body = _call(http, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["device"] == "cpu" and body["continuous"]["num_slots"] == 2


def test_generate_matches_jax_generate(bundles, http):
    jmodel, jparams, _ = bundles
    status, body = _call(http, "/v1/generate",
                         {"prompts": PROMPTS, "max_new_tokens": 12})
    assert status == 200
    for prompt, entry in zip(PROMPTS, body["completions"]):
        text, n_new = _jax_completion(jmodel, jparams, prompt, 12)
        assert entry["prompt"] == prompt
        assert entry["completion"] == text
        assert entry["new_tokens"] == n_new
    # a top-k request takes the whole-batch route; greedy ignores top_k
    status, body = _call(http, "/v1/generate",
                         {"prompt": PROMPTS[1], "max_new_tokens": 12,
                          "top_k": 5})
    assert status == 200
    assert body["completions"][0]["completion"] == _jax_completion(
        jmodel, jparams, PROMPTS[1], 12)[0]


def test_sampled_generate_is_deterministic_per_seed(http):
    body = {"prompts": PROMPTS[:2], "max_new_tokens": 10,
            "temperature": 0.8, "top_p": 0.9, "seed": 11}

    def texts():
        status, reply = _call(http, "/v1/generate", body)
        assert status == 200
        return [c["completion"] for c in reply["completions"]]

    assert texts() == texts()


def test_score_matches_jax(bundles, http):
    jmodel, jparams, _ = bundles
    texts = ["the quick brown fox", "a", "jumps over the lazy dog twice"]
    status, body = _call(http, "/v1/score", {"texts": texts})
    assert status == 200
    scores = body["scores"]
    assert scores[1] == {"nll": 0.0, "tokens": 0, "truncated": False,
                         "skipped": True}
    rows = [list(t.encode()) for t in (texts[0], texts[2])]
    padded = np.zeros((2, 64), np.int32)  # the JAX server's score bucket
    for r, ids in enumerate(rows):
        padded[r, :len(ids)] = ids
    ref = np.asarray(jax_score(jmodel, jparams, padded,
                               [len(r) for r in rows]))
    for r, i in enumerate((0, 2)):
        assert scores[i]["tokens"] == len(rows[r]) - 1
        np.testing.assert_allclose(scores[i]["nll"], ref[r], rtol=1e-4)


@pytest.mark.parametrize("body", [
    {"prompts": ["hi"], "num_beams": 2},
    {"prompts": ["hi"], "stream": True},
])
def test_unported_features_answer_400(http, body):
    status, reply = _call(http, "/v1/generate", body)
    assert status == 400 and "not yet ported" in reply["error"]


def test_bad_requests_answer_400(http):
    assert _call(http, "/v1/generate", {"prompts": "hi"})[0] == 400
    assert _call(http, "/v1/score", {"texts": [1]})[0] == 400
    assert _call(http, "/v1/generate",
                 {"prompts": ["hi"], "max_new_tokens": 500})[0] == 400


LONG_PROMPT = ("chunked prefill admits a long prompt in pieces of thirty-two "
               "tokens")  # 68 bytes: three pieces


def test_prefill_chunk_over_http_matches_jax_server(bundles):
    """``--prefill-chunk 32 --step-token-budget 40`` from the CLI: a long
    prompt beside two short ones admits through three pieces, and its
    greedy completion over HTTP equals the JAX server's with the same
    options on the same bundle; ``/healthz`` reports the pieces and the
    budget in the engine's stats, as the JAX server does."""
    from pyspark_tf_gke_tpu.train.serve import BundleServer as JaxServer
    from pyspark_tf_gke_tpu_torch.train.serve import parse_args

    jmodel, jparams, tdir = bundles
    prompts = [PROMPTS[0], LONG_PROMPT, PROMPTS[2]]
    args = parse_args(["--bundle", tdir, "--device", "cpu",
                       "--continuous-slots", "2", "--continuous-chunk", "4",
                       "--prefill-chunk", "32", "--step-token-budget", "40"])
    assert (args.prefill_chunk, args.step_token_budget) == (32, 40)
    server = BundleServer(args.bundle, device=args.device,
                          continuous_slots=args.continuous_slots,
                          continuous_chunk=args.continuous_chunk,
                          prefill_chunk=args.prefill_chunk,
                          step_token_budget=args.step_token_budget)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        status, body = _call(url, "/v1/generate",
                             {"prompts": prompts, "max_new_tokens": 12})
        assert status == 200
        _, health = _call(url, "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(10)
    jserver = JaxServer(str(Path(tdir).parent / "jax"), continuous_slots=2,
                        continuous_chunk=4, prefill_chunk=32,
                        step_token_budget=40)
    try:
        want = jserver.generate(prompts, max_new_tokens=12)
        jstats = jserver.health()["continuous"]
    finally:
        jserver._front.shutdown()
    for got, ref in zip(body["completions"], want):
        assert got["completion"] == ref["completion"]
    assert got["completion"] == _jax_completion(jmodel, jparams,
                                                prompts[2], 12)[0]
    stats = health["continuous"]
    assert stats["prefill_chunks"] == jstats["prefill_chunks"] == 3
    assert stats["step_token_budget"] == jstats["step_token_budget"] == 40
    with pytest.raises(ValueError, match="requires --continuous-slots"):
        BundleServer(tdir, device="cpu", prefill_chunk=32)
