"""PyTorch port, the dense slot-cache engine: a model without
``kv_num_pages`` runs ``ContinuousEngine`` over a dense ``[num_slots,
max_seq_len]`` cache, and given the same submits at the same steps its
greedy tokens equal the JAX dense ``ContinuousEngine``'s exactly (f32 on
the CPU, weights carried across with ``params_from_flax``): staggered
requests at decode-ahead depths 0 and 1, batched admission, the
``PrefixCache`` LRU (an exact hit, an extension, the strict-prefix
decline, eviction), chunked prefill through the batch-1 staging cache
(seeded by a hit too) and a cancel during it, in-engine speculation, an
int8 KV cache with eos, and the errors where the JAX engine refuses.
Sampled lanes are deterministic per seed, and a dense bundle served by
``BundleServer`` reports ``/loadz`` by the JAX server's rule.
"""

import threading

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu.train.continuous import PrefixCache as JaxPrefixCache
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train import continuous as tcont
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from tests.test_torch_engine import _models

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rope():
    """GQA 4/2 with rotary positions, f32, 128 positions, dense."""
    return _models(num_pages=None)


def _drive(engine, waves, steps_between=2, cancel=None):
    """Submit each wave of ``(prompt, max_new)`` after ``steps_between``
    steps of the previous one (``cancel``: ``(wave, index)`` of a request
    cancelled right after its wave's first step, while it is the
    piecewise admission), then drain; returns each request's tokens in
    submit order (None for the cancelled one) and the engine's stats."""
    rids, done = [], {}

    def step():
        for req in engine.step():
            done[req.rid] = list(req.tokens)

    for i, wave in enumerate(waves):
        rids += [engine.submit(p, max_new_tokens=m) for p, m in wave]
        for j in range(steps_between if i + 1 < len(waves) else 0):
            step()
            if cancel is not None and cancel[0] == i and j == 0:
                rid = rids[-len(wave) + cancel[1]]
                assert engine._admitting["req"].rid == rid
                assert engine.cancel(rid) and engine._admitting is None
    while engine.busy:
        step()
    return [done.get(r) for r in rids], engine.stats


def _both(models, waves, **kw):
    jmodel, params, tmodel = models
    ref, jstats = _drive(JaxEngine(jmodel, params, **kw), waves)
    out, stats = _drive(ContinuousEngine(tmodel, **kw), waves)
    return ref, out, jstats, stats


def _waves(seed, shape):
    rng = np.random.default_rng(seed)
    return [[(rng.integers(1, 97, n), m) for n, m in wave] for wave in shape]


STAGGERED = [[(5, 12), (19, 3), (33, 8)], [(7, 15), (11, 5)]]


@pytest.mark.parametrize("depth", [0, 1])
def test_staggered_requests_match_jax_dense_engine(rope, depth):
    waves = _waves(40, STAGGERED)
    ref, out, _, stats = _both(rope, waves, num_slots=2, chunk=3,
                               buckets=(16, 32, 64), pipeline_depth=depth)
    assert out == ref and all(t is not None for t in out)
    assert "paged" not in stats and stats["pipeline_depth"] == depth
    assert stats["finished"] == 5 and stats["active"] == 0


def test_batched_admission_matches_jax(rope):
    waves = _waves(41, [[(9, 6), (12, 7), (14, 5), (3, 9)]])
    ref, out, jstats, stats = _both(rope, waves, num_slots=4, chunk=4,
                                    buckets=(16, 32))
    assert out == ref
    assert stats["batch_admits"] == jstats["batch_admits"] == 4


def test_prefix_cache_hit_extend_decline_and_lru(rope):
    jmodel, params, tmodel = rope
    rng = np.random.default_rng(42)
    a, b, c = (rng.integers(1, 97, n) for n in (20, 12, 10))
    kw = dict(num_slots=2, chunk=4, prefix_cache_size=2,
              buckets=(16, 32, 64))
    engines = (JaxEngine(jmodel, params, **kw), ContinuousEngine(tmodel, **kw))
    for eng in engines:
        for prefix in (a, b, c):  # capacity 2: a is evicted by c
            assert eng.warm_prefix(prefix) == prefix.size
    wave = [(b, 6),                                       # exact hit
            (np.concatenate([b, rng.integers(1, 97, 5)]), 7),  # extend
            (b[:6], 5),                                   # strict prefix
            # a was evicted: only c's first token is in common
            (np.concatenate([a, rng.integers(1, 97, 3)]), 4),
            (np.concatenate([c, rng.integers(1, 97, 20)]), 6)]
    (ref, jstats), (out, stats) = (_drive(e, [wave]) for e in engines)
    assert out == ref
    assert stats["prefix_cache"] == jstats["prefix_cache"] == {
        "entries": 2, "capacity": 2, "hits": 4, "misses": 1}
    assert engines[1].prefix_cache._order == engines[0].prefix_cache._order
    assert tuple(a) not in engines[1].prefix_cache._entries
    # the lookup contract, entry for entry against the JAX class
    jcache, tcache = JaxPrefixCache(2), tcont.PrefixCache(2)
    for cache in (jcache, tcache):
        cache.put(b, "cache_b", "logits_b")
    for prompt in (b, b[:6], np.concatenate([b, [1, 2]]),
                   np.concatenate([b[:4], [0]]), c):
        got, want = tcache.lookup(prompt), jcache.lookup(prompt)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0] and got[2] == want[2]
    assert tcache.stats == jcache.stats


def test_chunked_prefill_seeded_by_a_hit_and_cancel_match_jax(rope):
    jmodel, params, tmodel = rope
    rng = np.random.default_rng(43)
    system = rng.integers(1, 97, 40)
    kw = dict(num_slots=2, chunk=4, prefill_chunk=32, step_token_budget=40,
              prefix_cache_size=2)
    waves = [[(rng.integers(1, 97, 100), 8), (rng.integers(1, 97, 16), 8)],
             [(rng.integers(1, 97, 100), 8), (rng.integers(1, 97, 16), 8)],
             [(np.concatenate([system, rng.integers(1, 97, 60)]), 6),
              (np.concatenate([system, rng.integers(1, 97, 5)]), 6),
              (rng.integers(1, 97, 90), 6)]]
    results = []
    for eng in (JaxEngine(jmodel, params, **kw),
                ContinuousEngine(tmodel, **kw)):
        eng.warm_prefix(system)
        # the second wave's long prompt is cancelled after its first piece
        results.append(_drive(eng, waves, steps_between=6, cancel=(1, 0)))
        assert eng._admitting is None and not eng.busy
    (ref, jstats), (out, stats) = results
    assert out == ref and out[2] is None
    assert all(t is not None for i, t in enumerate(out) if i != 2)
    for key in ("prefill_chunks", "prefill_tokens_computed", "finished",
                "prefix_cache"):
        assert stats[key] == jstats[key], key
    assert stats["prefill_chunks"] >= 6


def test_spec_tokens_match_jax(rope):
    waves = _waves(44, STAGGERED)
    ref, out, jstats, stats = _both(rope, waves, num_slots=2, chunk=8,
                                    spec_tokens=3)
    assert out == ref
    for key in ("proposed", "accepted", "rounds"):
        assert stats["spec"][key] == jstats["spec"][key], key
    assert stats["spec"]["self_draft"]


def test_int8_kv_cache_and_eos_match_jax():
    models = _models(pos="learned", kv_quant=True, num_pages=None)
    waves = _waves(45, [[(10, 8), (4, 9), (17, 6)]])
    kw = dict(num_slots=2, chunk=4, buckets=(16, 32))
    ref, out, _, _ = _both(models, waves, **kw)
    assert out == ref
    eos = ref[0][2]  # a token the first request emits: eos latches there
    ref_eos, out_eos, _, _ = _both(models, waves, eos_token_id=eos, **kw)
    assert out_eos == ref_eos and out_eos[0][-1] == eos


def test_refusals_match_jax(rope):
    """Where the JAX dense engine refuses, the port raises the same error
    type: the KV handoff (no radix cache), the page reads and writes,
    the paged prefill piece, and a warm without a prefix cache."""
    jmodel, params, tmodel = rope
    jeng = JaxEngine(jmodel, params, num_slots=2, chunk=2)
    eng = ContinuousEngine(tmodel, num_slots=2, chunk=2)
    prefix = np.arange(1, 40, dtype=np.int32)
    layers = [{} for _ in range(tmodel.cfg.num_layers)]
    jeng.submit([1, 2, 3], max_new_tokens=2)
    list(jeng.run_until_drained())  # the JAX device state exists
    calls = [
        (lambda: jeng.export_prefix_pages(prefix),
         lambda: eng.export_prefix_pages(prefix)),
        (lambda: jeng.import_prefix_pages(prefix, layers),
         lambda: eng.import_prefix_pages(prefix, layers)),
        (lambda: jeng._device.read_pages([0]), lambda: eng._read_pages([0])),
        (lambda: jeng._device.write_pages([0], layers),
         lambda: eng._write_pages([0], layers)),
        (lambda: jeng._device.prefill_chunk(np.zeros((1, 32), np.int32), 0,
                                            3, None),
         lambda: tcont._paged_prefill_chunk(tmodel, eng._state,
                                            np.zeros(32, np.int32), 0, 3,
                                            None)),
        (lambda: jeng.warm_prefix(prefix), lambda: eng.warm_prefix(prefix)),
    ]
    for jcall, tcall in calls:
        with pytest.raises(ValueError):
            jcall()
        with pytest.raises(ValueError):
            tcall()
    assert eng.warm_capacity == jeng.warm_capacity == 0


def test_sampled_lanes_are_deterministic_per_seed(rope):
    _, _, tmodel = rope
    rng = np.random.default_rng(46)
    specs = [(rng.integers(1, 97, 6), 10), (rng.integers(1, 97, 9), 10)]

    def run(seed):
        eng = ContinuousEngine(tmodel, num_slots=2, chunk=4, buckets=(16,))
        rids = [eng.submit(p, max_new_tokens=m, temperature=0.9, top_p=0.9,
                           seed=seed) for p, m in specs]
        out = dict(eng.run_until_drained())
        return [out[r] for r in rids]

    assert run(5) == run(5)
    assert run(5) != run(6)


def test_dense_bundle_serves_and_loadz_follows_the_jax_rule(tmp_path):
    """``BundleServer --continuous-slots`` on a dense bundle: requests
    complete through the slot engine, ``/loadz`` has no free pages and,
    with no queued-token bound, free slots x ``max_seq_len`` of
    capacity; ``/v1/prefill`` and ``/v1/kv_import`` are refused and the
    prefix LRU takes a warm."""
    from pyspark_tf_gke_tpu_torch.train import export as texport
    from pyspark_tf_gke_tpu_torch.train.serve import BundleServer

    cfg = tlm.CausalLMConfig(vocab_size=259, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_seq_len=128, dtype=torch.float32)
    bundle = texport.export_serving_bundle(
        cfg, tlm.init_params(cfg, seed=0), str(tmp_path / "dense"))
    server = BundleServer(bundle, device="cpu", continuous_slots=2,
                          continuous_chunk=4, prefix_cache_size=2)
    try:
        assert not server._front.engine.paged
        load = server.loadz()
        assert load["kv_pages_free"] is None and load["slots_total"] == 2
        assert load["capacity_free"] == 2 * cfg.max_seq_len
        assert server.warm_prefix("ab")["prefix_tokens"] == 2
        with pytest.raises(ValueError, match="paged radix"):
            server.prefill_export("abcdef")
        with pytest.raises(ValueError):
            server.kv_import("AAAA")
        done = []
        threads = [threading.Thread(target=lambda p=p: done.append(
            server.generate([p], max_new_tokens=5))) for p in ("ab", "xyz")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert len(done) == 2 and not any(t.is_alive() for t in threads)
        assert server._front.engine.stats["finished"] == 2
    finally:
        server.shutdown()
