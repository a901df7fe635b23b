"""PyTorch port, continuous-batching engine over the paged KV pool:
given the same submits, its greedy tokens equal the JAX
``ContinuousEngine``'s (paged config) exactly — under staggered
admission, slot reuse, learned positions with an int8 KV cache, a page
pool that runs dry and recovers, and chunked prefill under a step-token
budget (the same pieces and decode-chunk sizes step by step, the page
audit of ``tests/test_radix_cache.py`` green after every step). Pages
return to the pool when the engine is idle, and when a piecewise
admission is cancelled; sampled lanes are deterministic per seed.
All in f32 on the CPU: tokens are compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models.causal_lm import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train.continuous import (ContinuousEngine,
                                                       bucket_length)
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)
from tests.test_radix_cache import _check_page_invariants

torch.set_num_threads(1)


def _models(pos="rope", kv_quant=False, page_size=16, num_pages=24,
            **widths):
    fields = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=64, max_seq_len=128,
                  pos_embedding=pos)
    cfg = CausalLMConfig(**{**fields, **widths}, kv_cache_quant=kv_quant,
                         dtype=jnp.float32, kv_page_size=page_size,
                         kv_num_pages=num_pages)
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(params)).eval()
    return jmodel, params, tmodel


def _run(engine, specs, **kw):
    rids = [engine.submit(p, max_new_tokens=m, **kw) for p, m in specs]
    results = dict(engine.run_until_drained())
    return [results[r] for r in rids]


def test_bucket_length():
    assert bucket_length(1) == 32
    assert bucket_length(33) == 64
    with pytest.raises(ValueError, match="exceeds"):
        bucket_length(10_000)


def test_staggered_requests_match_jax_engine():
    jmodel, params, tmodel = _models()
    rng = np.random.default_rng(30)
    specs = [(rng.integers(1, 97, int(n)), int(m))
             for n, m in [(5, 12), (19, 3), (33, 8), (7, 15), (11, 5)]]
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64))
    ref = _run(JaxEngine(jmodel, params, **kw), specs)
    eng = ContinuousEngine(tmodel, **kw)
    assert _run(eng, specs) == ref
    st = eng.stats["paged"]
    assert st["pages_in_use"] == 0 and st["peak_pages_in_use"] > 0
    assert sorted(eng._free_pages) == list(range(24))  # full pool again
    assert not eng._page_refs and not eng._slot_pages
    assert eng.stats["batch_admits"] >= 2  # the batched prefill ran


def test_learned_positions_int8_kv_and_eos_match_jax_engine():
    jmodel, params, tmodel = _models(pos="learned", kv_quant=True)
    rng = np.random.default_rng(31)
    specs = [(rng.integers(1, 97, 10), 8), (rng.integers(1, 97, 4), 9)]
    kw = dict(num_slots=2, chunk=4, buckets=(16,))
    ref = _run(JaxEngine(jmodel, params, **kw), specs)
    assert _run(ContinuousEngine(tmodel, **kw), specs) == ref
    eos = ref[0][2]  # a token the first request emits: eos latches there
    kw["eos_token_id"] = eos
    ref_eos = _run(JaxEngine(jmodel, params, **kw), specs)
    out = _run(ContinuousEngine(tmodel, **kw), specs)
    assert out == ref_eos and out[0][-1] == eos


def test_pool_exhaustion_queues_and_recovers():
    # 4 pages of 16, each request needs 2 (10 + 20 tokens): two requests
    # hold pages at a time, the rest stay queued until frees return pages
    jmodel, params, tmodel = _models(num_pages=4)
    rng = np.random.default_rng(32)
    specs = [(rng.integers(1, 97, 10), 20) for _ in range(4)]
    kw = dict(num_slots=4, chunk=3, buckets=(16, 32))
    ref = _run(JaxEngine(jmodel, params, batch_admit=False, **kw), specs)
    eng = ContinuousEngine(tmodel, **kw)
    assert _run(eng, specs) == ref
    st = eng.stats["paged"]
    assert st["page_alloc_failures"] > 0
    assert st["pages_in_use"] == 0 and st["peak_pages_in_use"] <= 4
    assert sorted(eng._free_pages) == [0, 1, 2, 3]


def test_sampled_lanes_are_deterministic_per_seed():
    _, _, tmodel = _models()
    rng = np.random.default_rng(33)
    specs = [(rng.integers(1, 97, 6), 10), (rng.integers(1, 97, 9), 10)]

    def run(seed):
        eng = ContinuousEngine(tmodel, num_slots=2, chunk=4, buckets=(16,))
        return _run(eng, specs, temperature=0.9, top_p=0.9, seed=seed)

    assert run(5) == run(5)
    assert run(5) != run(6)


def test_oversized_request_and_unported_options_raise():
    _, _, tmodel = _models(num_pages=4)
    eng = ContinuousEngine(tmodel, num_slots=2, chunk=2, buckets=(16,))
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(np.arange(1, 11, dtype=np.int32), max_new_tokens=110)
    with pytest.raises(NotImplementedError, match="deadlines"):
        eng.submit([1, 2], max_new_tokens=2, deadline_s=1.0)
    for option in ("prefix_cache_size", "spec_tokens", "pipeline_depth",
                   "adaptive_chunk"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ContinuousEngine(tmodel, **{option: 2})
    dense = tlm.CausalLM(dataclasses.replace(tmodel.cfg, kv_num_pages=None))
    with pytest.raises(NotImplementedError, match="dense slot-cache"):
        ContinuousEngine(dense)


# -- chunked prefill and the step-token budget ----------------------------------

# the JAX cb --smoke chunked configuration (bench.py bench_chunked_prefill):
# GPT-2-style learned positions, 2 slots, chunk 4, 32-token pages, pieces
# of 32, a 40-token step budget, 6 requests of 16 tokens with every 4th a
# 100-token prompt, 8 new tokens each
CB_SMOKE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=None, intermediate_size=128, max_seq_len=256)
CB_KW = dict(num_slots=2, chunk=4, prefill_chunk=32, step_token_budget=40)


def _cb_prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, 100 if i % 4 == 3 else 16).astype(np.int32)
            for i in range(n)]


def _record_sizes(engine, method):
    """Record the decode-chunk size of every dispatch."""
    sizes, inner = [], getattr(engine, method)

    def wrapped(size, *args, **kw):
        sizes.append(int(size))
        return inner(size, *args, **kw)

    setattr(engine, method, wrapped)
    return sizes


def _drive_audited(engine, specs):
    """Submit ``specs`` and step to the end, auditing the page pool after
    every step; returns each request's tokens in submit order."""
    rids = [engine.submit(p, max_new_tokens=m) for p, m in specs]
    done = {}
    while engine.busy:
        for req in engine.step():
            done[req.rid] = req.tokens
        _check_page_invariants(engine)
    return [done[r] for r in rids]


@pytest.mark.parametrize("kv_quant,budget", [(False, 40), (True, 40),
                                             (False, 20)],
                         ids=["f32_kv", "int8_kv", "f32_kv_budget20"])
def test_chunked_prefill_matches_jax_engine(kv_quant, budget):
    """The cb smoke configuration (budget 40: a step with a 32-token
    piece and 2 live slots keeps the whole 4-step chunk), and a budget
    of 20 under which a step with a piece decodes a single step."""
    jmodel, params, tmodel = _models(pos="learned", kv_quant=kv_quant,
                                     page_size=32, num_pages=16, **CB_SMOKE)
    specs = [(p, 8) for p in _cb_prompts()]
    kw = dict(CB_KW, step_token_budget=budget)
    jeng = JaxEngine(jmodel, params, **kw)
    jsizes = _record_sizes(jeng, "_dispatch_chunk")
    ref = _run(jeng, specs)
    eng = ContinuousEngine(tmodel, **kw)
    sizes = _record_sizes(eng, "_run_chunk")
    assert _drive_audited(eng, specs) == ref
    assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"] > 0
    assert sizes == jsizes
    assert (min(sizes) == 1) == (budget == 20)  # the cap bit at 20 only
    assert eng.stats["step_token_budget"] == budget
    assert eng.stats["admitting"] is None
    assert sorted(eng._free_pages) == list(range(16))


def test_cancel_during_piecewise_admission_returns_every_page():
    _, _, tmodel = _models(pos="learned", page_size=32, num_pages=16,
                           **CB_SMOKE)
    eng = ContinuousEngine(tmodel, **CB_KW)
    short, long_ = _cb_prompts()[0], _cb_prompts()[3]
    a = eng.submit(short, max_new_tokens=8)
    b = eng.submit(long_, max_new_tokens=8)
    eng.step()  # admits both: b's first 32-token piece runs
    assert eng.stats["admitting"] == b and eng.stats["prefill_chunks"] == 1
    held = len(eng._admitting["pages"])
    assert held == 1  # the first piece's real tokens: one 32-token page
    assert eng.stats["paged"]["pages_in_use"] == held + len(
        eng._slot_pages[0])
    assert eng.cancel(b)
    assert eng.stats["admitting"] is None
    _check_page_invariants(eng)
    out = dict(eng.run_until_drained())
    assert list(out) == [a] and len(out[a]) == 8
    assert sorted(eng._free_pages) == list(range(16))
    assert not eng._page_refs and not eng._slot_pages


def test_failed_piece_returns_its_pages_and_requeues_its_request(
        monkeypatch):
    """A piece that raises (a device fault) hands back every page the
    admission holds and puts its request back at the queue head, where
    ``outstanding_requests`` (the serving front's list of waiters to
    fail) finds it; an engine driven on re-admits it from its first piece
    and gives the tokens of an engine that never failed."""
    from pyspark_tf_gke_tpu_torch.train import continuous as tc

    _, _, tmodel = _models(pos="learned", page_size=32, num_pages=16,
                           **CB_SMOKE)
    specs = [(_cb_prompts()[3], 8), (_cb_prompts()[0], 8)]
    ref = _run(ContinuousEngine(tmodel, **CB_KW), specs)
    eng = ContinuousEngine(tmodel, **CB_KW)
    rids = [eng.submit(p, max_new_tokens=m) for p, m in specs]
    eng.step()  # the long prompt's first piece
    inner, calls = tc._paged_prefill_chunk, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected piece fault")
        return inner(*args, **kw)

    monkeypatch.setattr(tc, "_paged_prefill_chunk", failing)
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()  # the second piece fails
    _check_page_invariants(eng)
    assert eng.stats["admitting"] is None
    assert eng._queue[0].rid == rids[0]
    assert rids[0] in [r.rid for r in eng.outstanding_requests()]
    out = dict(eng.run_until_drained())
    assert [out[r] for r in rids] == ref
    assert sorted(eng._free_pages) == list(range(16))


def test_prefill_chunk_and_budget_refusals_match_jax():
    jmodel, params, tmodel = _models(pos="learned", page_size=32,
                                     num_pages=16, **CB_SMOKE)
    for kw, match in ((dict(prefill_chunk=16), "prefill_chunk must be 0"),
                      (dict(step_token_budget=-1), "step_token_budget")):
        with pytest.raises(ValueError, match=match):
            JaxEngine(jmodel, params, **kw)
        with pytest.raises(ValueError, match=match):
            ContinuousEngine(tmodel, **kw)


def test_prompt_longer_than_the_largest_bucket_admits_through_pieces():
    jmodel, params, tmodel = _models(pos="learned", page_size=32,
                                     num_pages=16, **CB_SMOKE)
    kw = dict(num_slots=2, chunk=4, buckets=(32,), prefill_chunk=32)
    eng = ContinuousEngine(tmodel, num_slots=2, chunk=4, buckets=(32,))
    long_ = _cb_prompts()[3]  # 100 tokens > the 32-token bucket
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.submit(long_, max_new_tokens=8)
    specs = [(long_, 8), (_cb_prompts()[0], 8)]
    ref = _run(JaxEngine(jmodel, params, **kw), specs)
    eng = ContinuousEngine(tmodel, **kw)
    assert _drive_audited(eng, specs) == ref
    assert eng.stats["prefill_chunks"] == 4  # 32 + 32 + 32 + 4
