"""PyTorch port, the serving CLI over two processes: ``serve.main`` with
``--tp 2 --num-processes 2`` on the CPU (one gloo world of 2 ranks,
``tests/torch_p11_world.py``, runner ``serve_cli``). Rank 0 answers HTTP
and announces; rank 1 replays in ``serve_worker_loop``.

* ``/healthz`` reports ``tp`` 2; greedy generate, beams, ``/v1/score``
  and an SSE stream give the one-process server's tokens (scores within
  1e-4 nats: the tp row-parallel sums round differently in f32); a
  seeded sampled request repeats;
* ``/admin/reload`` answers the JAX server's single-host error (400);
* SIGTERM on rank 0 drains: the request in flight completes, both
  processes exit 0;
* a draft bundle deployed on rank 1 only fails at startup on rank 1
  (``sync_serving_config``), before any request.
"""

import json
import socket

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
from pyspark_tf_gke_tpu_torch.train.serve import BundleServer
from tests.torch_p11_world import run_world

torch.set_num_threads(1)

TOKEN = "tok"
GREEDY = {"prompts": ["hello", "xyz"], "max_new_tokens": 8}
BEAMS = {"prompts": ["hello"], "max_new_tokens": 5, "num_beams": 2}
SCORE = {"texts": ["hello world", "abc"]}
STREAM = {"prompts": ["hello"], "max_new_tokens": 6, "stream": True}
SAMPLED = {"prompts": ["ab"], "max_new_tokens": 8, "temperature": 0.9,
           "seed": 3}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bundle(path, layers: int, seed: int) -> str:
    cfg = tlm.CausalLMConfig(vocab_size=259, hidden_size=32,
                             num_layers=layers, num_heads=4, num_kv_heads=2,
                             intermediate_size=64, max_seq_len=128,
                             dtype=torch.float32, kv_page_size=16,
                             kv_num_pages=32)
    return export_serving_bundle(cfg, tlm.init_params(cfg, seed), str(path),
                                 quantize=False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_cli")
    tdir = _bundle(root / "target", 2, 1)
    ddir = _bundle(root / "draft", 1, 2)
    common = ["--bundle", tdir, "--device", "cpu", "--continuous-slots", "2",
              "--continuous-chunk", "4", "--tp", "2", "--num-processes", "2",
              "--process-id", "{rank}", "--coordinator-addr", "127.0.0.1",
              "--coordinator-port", "{port}"]
    http = common + ["--host", "127.0.0.1", "--port", "{http}",
                     "--drain-timeout", "60"]
    admin = {"X-Admin-Token": TOKEN}
    runs = {
        "http": dict(http_port=_free_port(), argv=[http, http], calls=[
            ("greedy", "/v1/generate", GREEDY, None),
            ("sampled_a", "/v1/generate", SAMPLED, None),
            ("sampled_b", "/v1/generate", SAMPLED, None),
            ("beams", "/v1/generate", BEAMS, None),
            ("score", "/v1/score", SCORE, None),
            ("stream", "/v1/generate", STREAM, None),
            ("reload", "/admin/reload", {"bundle": tdir}, admin),
            ("drained", "/v1/generate",
             {"prompts": ["drain me"], "max_new_tokens": 100}, None)]),
        "draft_on_one_rank": dict(argv=[
            common + ["--stdin"], common + ["--draft-bundle", ddir]]),
    }
    results = run_world("serve_cli", {"runs": runs,
                                      "env": {"SERVE_ADMIN_TOKEN": TOKEN}},
                        str(root), world=2)
    one = BundleServer(tdir, device="cpu", continuous_slots=2,
                       continuous_chunk=4)
    try:
        ref = {"greedy": one.generate(GREEDY["prompts"], 8),
               "beams": one.generate(BEAMS["prompts"], 5, num_beams=2),
               "score": one.score(SCORE["texts"]),
               "stream": one.generate(STREAM["prompts"], 6)}
    finally:
        one.shutdown()
    return results, ref


def test_http_over_two_processes_matches_one_process(world):
    results, ref = world
    got = results[0]["http"]
    status, health = got["healthz"]
    assert status == 200 and health["tp"] == 2
    for name in ("greedy", "beams"):
        status, body = got[name]
        assert status == 200
        assert [r["completion"] for r in body["completions"]] == [
            r["completion"] for r in ref[name]]
    status, body = got["score"]
    assert status == 200
    np.testing.assert_allclose([r["nll"] for r in body["scores"]],
                               [r["nll"] for r in ref["score"]], atol=1e-4)
    sampled = [[r["completion"] for r in got[name][1]["completions"]]
               for name in ("sampled_a", "sampled_b")]
    assert sampled[0] == sampled[1]
    status, lines = got["stream"]
    assert status == 200 and lines[-1] == "data: [DONE]"
    terminal = json.loads(lines[-2][len("data:"):])
    assert terminal["completion"] == ref["stream"][0]["completion"]


def test_reload_answers_the_single_host_error(world):
    status, body = world[0][0]["http"]["reload"]
    assert status == 400 and "single-host only" in body["error"]


def test_drain_completes_the_inflight_request_and_both_exit_0(world):
    results, _ = world
    status, body = results[0]["http"]["drained"]
    assert status == 200 and body["completions"][0]["new_tokens"] == 100
    assert results[0]["http"]["exit"] == 0
    assert results[1]["http"]["exit"] == 0


def test_draft_bundle_on_one_rank_fails_at_startup(world):
    results, _ = world
    assert "serving config mismatch" in str(
        results[1]["draft_on_one_rank"]["exit"])
