"""PyTorch port, tensor-parallel serving over the serve wire: ONE gloo
world of 4 CPU ranks (``tests/torch_p11_world.py``, runner ``serve``)
runs every case; rank 0 drives announcing slot engines and whole-batch
requests, ranks 1-3 replay them in ``serve_worker_loop``. At ``dp=2,
tp=2`` ranks 2-3 are a second tp pair replaying the same program.

* greedy tokens of the paged engine (bf16-valued weights; chunked
  prefill, the radix cache and decode-ahead on), the dense engine, int8
  weights (K6's plain version on each rank's slices), MQA (``kv=1`` at
  tp=2) and GQA (``kv=2`` at tp=4) equal the JAX ``ContinuousEngine``'s
  on a fake-device tp mesh of the same width, exactly;
* against the port's one-process engine and entry points: sampled slot
  lanes, whole-batch sampling and beams (identical on every rank, as the
  workers' replays record them), the spec engine with a draft and the
  standalone speculative driver (the greedy tokens, with accepted draft
  tokens advancing every rank's fills: the draft is the target's
  weights);
* the KV handoff: a blob exported by a one-process engine imports at
  tp=2 (each rank installs its heads) and a tp=2 export (the ranks'
  heads gathered) imports into one process; both give the tokens of a
  cold prefill.

All f32 compute on the CPU: greedy tokens are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models.causal_lm import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.ops import quant as jquant
from pyspark_tf_gke_tpu.parallel.mesh import make_mesh as jmake_mesh
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu.train.serving import shard_params_for_serving
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)
from tests.torch_p11_world import run_world

torch.set_num_threads(1)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=128,
            dtype=jnp.float32, kv_page_size=16, kv_num_pages=24)
GREEDY_KW = dict(num_slots=2, chunk=3, buckets=(16, 32, 64))


def _jax(seed=3, quantize=False, bf16=False, **over):
    """``(cfg, flax params, port fields, port params)``."""
    cfg = CausalLMConfig(**{**TINY, **over})
    params = jax.device_get(nn.meta.unbox(CausalLM(cfg).init(
        jax.random.key(seed), jnp.ones((1, 8), jnp.int32))["params"]))
    if bf16:
        params = jax.tree.map(lambda x: np.asarray(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), params)
    if quantize:
        params = jax.device_get(jquant.quantize_tree(params, min_size=512))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    return cfg, params, fields, params_from_flax(params)


def _port(fields, tparams):
    return tlm.CausalLM(config_from_dict(fields)).load_params(tparams).eval()


def _run(engine, specs):
    rids = [engine.submit(p, max_new_tokens=m, **kw) for p, m, kw in specs]
    done = dict(engine.run_until_drained())
    return [done[r] for r in rids]


def _jax_tp(cfg, params, tp, specs, **kw):
    """The JAX engine's tokens on a fake-device ``tp`` mesh."""
    mesh = jmake_mesh({"tp": tp}, jax.devices()[:tp])
    model = CausalLM(cfg, mesh=mesh)
    placed = shard_params_for_serving(model, params, mesh)
    return _run(JaxEngine(model, placed, mesh=mesh, **kw), specs)


def _greedy_specs(rng):
    return [(rng.integers(1, 97, int(n)), int(m), {})
            for n, m in [(5, 7), (40, 4), (11, 6)]]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(40)
    cases, expect = {}, {}

    # the paged engine at dp=2, tp=2: bf16-valued weights, a draft of
    # the same weights (it agrees with the target, so rounds accept)
    cfg, params, fields, tparams = _jax(bf16=True)
    greedy = _greedy_specs(rng)
    sampled = [(rng.integers(1, 97, 6), 6,
                dict(temperature=0.9, top_p=0.9, seed=s)) for s in (5, 6)]
    one = _port(fields, tparams)
    prefix_in, prefix_out = rng.integers(1, 97, 33), rng.integers(1, 97, 36)
    src = ContinuousEngine(one, prefix_cache_size=16, **GREEDY_KW)
    src.warm_prefix(prefix_in)
    blob = src.export_prefix_pages(prefix_in)
    xfer = [(np.concatenate([prefix_in, rng.integers(1, 97, 4)]), 5, {})]
    whole_prompt = rng.integers(1, 97, (2, 6)).astype(np.int32)
    cases["paged_tp2"] = dict(
        mesh={"dp": 2, "tp": 2}, cfg=fields, params=tparams,
        draft_cfg=fields, draft_params=tparams,
        engines=[("greedy", dict(GREEDY_KW, prefill_chunk=32,
                                 prefix_cache_size=16, pipeline_depth=1),
                  greedy),
                 ("sampled", GREEDY_KW, sampled),
                 ("spec", dict(GREEDY_KW, chunk=4, spec_tokens=2), greedy),
                 ("xfer", dict(GREEDY_KW, prefix_cache_size=16), xfer)],
        whole={"sampled_whole": dict(prompt=whole_prompt, max_new_tokens=6,
                                     temperature=0.9, top_p=0.9, seed=123),
               "beam": dict(prompt=whole_prompt, max_new_tokens=5,
                            num_beams=3)},
        spec_prompt=rng.integers(1, 97, (1, 7)).astype(np.int32),
        export=prefix_out,
        **{"import": (blob["token_ids"], blob["layers"])})
    expect["paged_tp2"] = dict(
        greedy=_jax_tp(cfg, params, 2, greedy, **GREEDY_KW),
        one=one, sampled=_run(ContinuousEngine(one, **GREEDY_KW), sampled),
        xfer=_run(ContinuousEngine(one, **GREEDY_KW), xfer),
        prefix_out=prefix_out)

    # the dense engine, int8 weights, MQA at tp=2 and GQA kv=2 at tp=4
    for name, over, tp in [
            ("dense_tp2", dict(kv_num_pages=None), 2),
            ("int8_tp2", dict(quantize=True), 2),
            ("mqa_tp2", dict(num_kv_heads=1), 2),
            ("gqa_tp4", dict(num_kv_heads=2), 4)]:
        cfg, params, fields, tparams = _jax(**over)
        specs = _greedy_specs(rng)
        kw = dict(GREEDY_KW, pipeline_depth=1)
        cases[name] = dict(mesh={"dp": 4 // tp, "tp": tp}, cfg=fields,
                           params=tparams, engines=[("greedy", kw, specs)])
        expect[name] = dict(greedy=_jax_tp(cfg, params, tp, specs, **kw))
    results = run_world("serve", {"cases": cases},
                        str(tmp_path_factory.mktemp("serve")), world=4)
    return cases, expect, results


@pytest.mark.parametrize("case", ["paged_tp2", "dense_tp2", "int8_tp2",
                                  "mqa_tp2", "gqa_tp4"])
def test_greedy_tokens_match_jax_tp_engine(world, case):
    _, expect, results = world
    assert results[0][case]["greedy"] == expect[case]["greedy"]
    for rank in (1, 2, 3):  # every worker replayed the ops
        assert results[rank][case]["served"] > 0


def test_sampled_lanes_and_spec_match_one_process(world):
    _, expect, results = world
    got, want = results[0]["paged_tp2"], expect["paged_tp2"]
    assert got["sampled"] == want["sampled"]
    # the spec engine (a draft on the same mesh) and the standalone
    # speculative driver give the greedy tokens, with draft tokens
    # accepted
    assert got["spec"] == want["greedy"]
    assert got["spec_accepted"] > 0 and got["mh_spec_accepted"] > 0
    cases = world[0]
    prompt = cases["paged_tp2"]["spec_prompt"]
    ref = tlm.generate(want["one"], prompt, 8).numpy()
    np.testing.assert_array_equal(got["mh_spec"], ref)


def test_whole_batch_identical_on_every_rank(world):
    cases, expect, results = world
    case, one = cases["paged_tp2"], expect["paged_tp2"]["one"]
    rank0 = results[0]["paged_tp2"]
    prompt = case["whole"]["sampled_whole"]["prompt"]
    gen = torch.Generator().manual_seed(123)
    ref = tlm.generate(one, prompt, 6, temperature=0.9, generator=gen,
                       top_p=0.9).numpy()
    np.testing.assert_array_equal(rank0["sampled_whole"], ref)
    seqs, scores = beam_search(one, prompt, 5, num_beams=3)
    np.testing.assert_array_equal(rank0["beam"][0], seqs.numpy())
    np.testing.assert_allclose(rank0["beam"][1], scores.numpy(), atol=1e-5)
    for rank in (1, 2, 3):
        whole = results[rank]["paged_tp2"]["whole"]
        np.testing.assert_array_equal(whole[0], rank0["sampled_whole"])
        np.testing.assert_array_equal(whole[1][0], rank0["beam"][0])
        np.testing.assert_array_equal(whole[1][1], rank0["beam"][1])


def test_kv_handoff_one_process_to_tp_and_back(world):
    _, expect, results = world
    got, want = results[0]["paged_tp2"], expect["paged_tp2"]
    # one process -> tp=2: the imported pages serve the hit as a cold
    # prefill would
    assert got["imported"] == 32
    assert got["xfer"] == want["xfer"]
    # tp=2 -> one process: the export holds every KV head
    tokens, layers = got["export"]
    assert layers[0]["k_pages"].shape[2] == TINY["num_kv_heads"]
    one = want["one"]
    prompt = [(np.concatenate([want["prefix_out"], [7, 8, 9]]), 5, {})]
    cold = _run(ContinuousEngine(one, **GREEDY_KW), prompt)
    eng = ContinuousEngine(one, prefix_cache_size=16, **GREEDY_KW)
    assert eng.import_prefix_pages(tokens, layers) == 32
    assert _run(eng, prompt) == cold
    assert eng.stats["prefix_cache"]["hits"] >= 1
