"""PyTorch port, continuous-batching engine over the paged KV pool:
given the same submits, its greedy tokens equal the JAX
``ContinuousEngine``'s (paged config) exactly — under staggered
admission, slot reuse, learned positions with an int8 KV cache, and a
page pool that runs dry and recovers. Pages return to the pool when the
engine is idle; sampled lanes are deterministic per seed.
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

torch.set_num_threads(1)


def _models(pos="rope", kv_quant=False, page_size=16, num_pages=24):
    cfg = CausalLMConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=64, max_seq_len=128,
        pos_embedding=pos, kv_cache_quant=kv_quant, dtype=jnp.float32,
        kv_page_size=page_size, kv_num_pages=num_pages)
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
    for option in ("prefill_chunk", "prefix_cache_size", "spec_tokens",
                   "pipeline_depth", "adaptive_chunk"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ContinuousEngine(tmodel, **{option: 2})
    dense = tlm.CausalLM(dataclasses.replace(tmodel.cfg, kv_num_pages=None))
    with pytest.raises(NotImplementedError, match="dense slot-cache"):
        ContinuousEngine(dense)
