"""PyTorch port, beam search (``models/beam_search.py``) against the JAX
package's ``beam_search`` on the same f32 parameters (carried across with
``params_from_flax``): equal sequences and scores within 1e-5 at K = 1,
2, 4 with and without eos, beam 1 equal to greedy ``generate``, eos
finishing and padding, the short finished hypothesis, GQA and int8
bundles, the validation errors, and over HTTP the torch server's
``beam_score`` equal to the JAX server's.
"""

import dataclasses
import json
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.models import beam_search as jbeam
from pyspark_tf_gke_tpu.models import generate as jgenerate
from pyspark_tf_gke_tpu.ops.quant import quantize_tree
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)

torch.set_num_threads(1)

TINY = dict(vocab_size=53, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_seq_len=32, dtype=jnp.float32)


def _pair(seed=0, **over):
    """``(jax model, params, torch model)`` on the same f32 weights."""
    cfg = CausalLMConfig(**{**TINY, **over})
    model = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(model.init(
        jax.random.key(seed), jnp.zeros((1, 6), jnp.int32))["params"]))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(params)).eval()
    return model, params, tmodel


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=3)


def _check(jres, tres):
    seqs, scores = tres
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jres[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jres[1]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("eos", [None, 5])
def test_beam_search_equals_jax(pair, k, eos):
    model, params, tmodel = pair
    prompt = np.random.default_rng(k).integers(1, 53, (3, 6)).astype(np.int32)
    _check(jbeam(model, params, jnp.asarray(prompt), 10, num_beams=k,
                 eos_token_id=eos),
           beam_search(tmodel, prompt, 10, num_beams=k, eos_token_id=eos))


def test_beam1_equals_greedy(pair):
    _, _, tmodel = pair
    prompt = np.random.default_rng(1).integers(0, 53, (2, 4))
    greedy = tlm.generate(tmodel, prompt, max_new_tokens=6)
    beams, scores = beam_search(tmodel, prompt, 6, num_beams=1,
                                length_penalty=0.0)
    assert torch.equal(beams, greedy) and torch.isfinite(scores).all()


def test_beam_eos_finishes_and_pads():
    model, params, tmodel = _pair(seed=4)
    prompt = np.zeros((2, 3), np.int32)
    eos = int(tlm.generate(tmodel, prompt, max_new_tokens=1)[0, 3])
    jres = jbeam(model, params, jnp.asarray(prompt), 8, num_beams=3,
                 eos_token_id=eos, length_penalty=1.0)
    beams, scores = beam_search(tmodel, prompt, 8, num_beams=3,
                                eos_token_id=eos, length_penalty=1.0)
    _check(jres, (beams, scores))
    toks = beams[:, 3:].numpy()
    assert (toks == eos).any(axis=1).all()
    for row in toks:
        first = int(np.argmax(row == eos))
        assert (row[first:] == eos).all()


def test_beam_short_finished_hypothesis_survives():
    model, params, tmodel = _pair(seed=6)
    prompt = np.zeros((1, 3), np.int32)
    eos = int(tlm.generate(tmodel, prompt, max_new_tokens=1)[0, 3])
    with torch.inference_mode():
        lp0 = torch.log_softmax(tmodel(torch.zeros(1, 3, dtype=torch.long))
                                [0, -1], dim=-1)[eos].item()
    jres = jbeam(model, params, jnp.asarray(prompt), 6, num_beams=2,
                 eos_token_id=eos, length_penalty=0.0)
    tres = beam_search(tmodel, prompt, 6, num_beams=2, eos_token_id=eos,
                       length_penalty=0.0)
    _check(jres, tres)
    assert tres[1][0].item() >= lp0 - 1e-5


@pytest.mark.parametrize("int8", [False, True], ids=["gqa", "gqa_int8"])
def test_beam_with_gqa_and_int8(int8):
    """One key/value head; with int8 weights the JAX search dequantizes
    in its loop and the port's bundle loader once, to the same f32
    values."""
    model, params, _ = _pair(seed=5, num_kv_heads=1)
    cfg = dict(TINY, num_kv_heads=1)
    fields = dataclasses.asdict(CausalLMConfig(**cfg))
    fields["dtype"] = "float32"
    jparams = quantize_tree(params, min_size=64) if int8 else params
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(jax.device_get(jparams))).eval()
    prompt = np.random.default_rng(8).integers(0, 53, (2, 3)).astype(np.int32)
    jres = jbeam(model, jparams, jnp.asarray(prompt), 5, num_beams=2)
    tres = beam_search(tmodel, prompt, 5, num_beams=2)
    assert tres[0].shape == (2, 8)
    _check(jres, tres)


@pytest.mark.parametrize("kw,match", [
    ({"num_beams": 0}, "num_beams"),
    ({"num_beams": 53}, "num_beams"),
    ({"num_beams": 2, "eos_token_id": 999}, "eos_token_id"),
    ({"num_beams": 2, "eos_token_id": -1}, "eos_token_id"),
    ({"num_beams": 2, "max_new_tokens": 0}, "max_new_tokens"),
    ({"num_beams": 2, "max_new_tokens": 30}, "max_seq_len"),
])
def test_validation_errors_as_the_jax_search(pair, kw, match):
    model, params, tmodel = pair
    kw = dict(kw)
    n = kw.pop("max_new_tokens", 2)
    prompt = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match=match):
        jbeam(model, params, jnp.asarray(prompt), n, **kw)
    with pytest.raises(ValueError, match=match):
        beam_search(tmodel, prompt, n, **kw)


def test_http_beam_score_equals_the_jax_servers(tmp_path):
    """``num_beams`` over HTTP: the torch server (continuous slots: beams
    take the whole-batch path) answers the JAX server's completions and
    ``beam_score``s on the same bundle."""
    from pyspark_tf_gke_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from pyspark_tf_gke_tpu.train import export as jexport
    from pyspark_tf_gke_tpu.train import serve as jserve
    from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
    from pyspark_tf_gke_tpu_torch.train import export as texport
    from pyspark_tf_gke_tpu_torch.train import serve as tserve

    cfg = CausalLMConfig(vocab_size=259, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64, max_seq_len=64,
                         dtype=jnp.float32, kv_page_size=16, kv_num_pages=16)
    model = CausalLM(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(9),
                                      jnp.ones((1, 8), jnp.int32))["params"])
    jdir = jexport.export_serving_bundle(cfg, params, str(tmp_path / "j"),
                                         quantize=True)
    _, jp, meta = jexport.load_serving_bundle(jdir)
    tdir = texport.export_serving_bundle(
        texport.config_from_dict(meta["config"]),
        texport.params_from_flax(jax.device_get(jp)), str(tmp_path / "t"))
    body = {"prompts": ["beam me", "up", "scotty!"], "max_new_tokens": 8,
            "num_beams": 3}
    servers = [jserve.BundleServer(jdir, continuous_slots=2,
                                   continuous_chunk=4,
                                   registry=JaxRegistry()),
               tserve.BundleServer(tdir, device="cpu", continuous_slots=2,
                                   continuous_chunk=4,
                                   registry=MetricsRegistry())]
    replies = []
    for server, mod in zip(servers, (jserve, tserve)):
        httpd = mod.start_http_server(server, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate",
            data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                replies.append(json.loads(resp.read())["completions"])
        finally:
            httpd.shutdown()
            httpd.server_close()
            server._front.shutdown()
    want, got = replies
    assert [e["completion"] for e in got] == [e["completion"] for e in want]
    assert [e["new_tokens"] for e in got] == [e["new_tokens"] for e in want]
    np.testing.assert_allclose([e["beam_score"] for e in got],
                               [e["beam_score"] for e in want], atol=1e-5)
    assert Path(tdir).is_dir()
