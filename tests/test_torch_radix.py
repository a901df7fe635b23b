"""PyTorch port, the radix prefix cache and the KV page handoff.

* The port's ``RadixPrefixCache`` and the JAX one, driven by the same
  operation sequences (those of ``tests/test_radix_cache.py:54-137`` and
  a seeded random one), give equal matches, inserts, evictions and
  stats.
* At engine level (f32 on the CPU, widths of the cb smoke configuration:
  hidden 64, 2 layers, vocab 512, 16-token pages): a radix hit is
  token-exact against the cache off and against the JAX engine at the
  same ``prefix_cache_size``, with the JAX engine's
  ``prefill_tokens_computed`` and cache stats; the page audit of
  ``tests/test_radix_cache.py`` is green after every step; the
  near-context-limit guard skips the insert where the JAX engine skips
  it (its overshoot term grows with ``pipeline_depth``); ``warm_prefix``
  then a chunked hit works.
* Handoff: pages exported by the JAX engine and imported by the port
  continue token-exact, and the reverse, with f32 and int8 pages; the
  two packages' ``pack_kv_export`` write the same bytes and each
  ``unpack_kv_blob`` reads the other's, a bf16 pool included; the port
  carries layers in the JAX engine's wire order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models.causal_lm import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.train import continuous as jc
from pyspark_tf_gke_tpu.train import kv_transfer as jkv
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train import continuous as tc
from pyspark_tf_gke_tpu_torch.train import kv_transfer as tkv
from pyspark_tf_gke_tpu_torch.train.continuous import (ContinuousEngine,
                                                       RadixPrefixCache)
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)
from tests.test_radix_cache import _check_page_invariants
from tests.test_torch_engine import CB_SMOKE, JaxEngine, _models

torch.set_num_threads(1)

V = CB_SMOKE["vocab_size"]


# -- the trie against the JAX trie ------------------------------------------------

TRIE_CASES = {
    "match_cow": (4, 16, [
        ("insert", list(range(100, 110)), [7, 8, 9]),
        ("match", list(range(100, 110)) + [999], {}),
        ("match", [100, 101, 102, 103, 104, 105, 777, 888], {}),
        ("match", list(range(100, 110)), {}),
        ("match", [1, 2, 3, 4, 5], {})]),
    "insert_dedup_upgrade": (4, 16, [
        ("insert", [1, 2, 3, 4, 5, 6], [10, 11]),
        ("insert", [1, 2, 3, 4, 5, 6, 7], [20, 21]),
        ("match", [1, 2, 3, 4, 5, 6, 7, 9], {}),
        ("insert", [1, 2, 3, 4, 5], [30, 31]),
        ("insert", [1, 2, 3, 4, 5, 8], [40, 41]),
        ("match", [1, 2, 3, 4, 5, 8, 9], {})]),
    "lru_eviction_busy": (2, 16, [
        ("insert", [1, 2, 3, 4], [0, 1]),
        ("insert", [5, 6], [2]),
        ("match", [1, 2, 3, 4, 9], {}),
        ("evict", 1, ()),
        ("evict", 2, ()),
        ("insert", [1, 2], [5]),
        ("evict", 1, (5,))]),
    "windowed_hit_rate": (4, 16, [
        ("insert", list(range(8)), [0, 1]),
        ("match", list(range(8)) + [99], {}),
        ("match", list(range(8)) + [99], {"count": False}),
        ("note", 0),
        *[("match", [1000 + i, 2000 + i], {}) for i in range(64)]]),
}


def _random_ops(seed=0, n=200):
    """Inserts over a few shared stems, matches with every option,
    evictions with random busy sets and explicit notes."""
    rng = np.random.default_rng(seed)
    stems = [list(rng.integers(0, 6, 9)) for _ in range(3)]
    ops, page = [], 0
    for _ in range(n):
        kind = rng.choice(["insert", "match", "match", "evict", "note"])
        toks = [int(t) for t in stems[rng.integers(3)][:rng.integers(1, 9)]
                + list(rng.integers(0, 6, rng.integers(0, 6)))]
        if kind == "insert":
            pages = list(range(page, page + -(-len(toks) // 4)))
            page += len(pages)
            ops.append(("insert", toks, pages))
        elif kind == "match":
            opts = {}
            if rng.random() < 0.3:
                opts["limit"] = int(rng.integers(0, len(toks) + 2))
            if rng.random() < 0.2:
                opts["peek"] = True
            if rng.random() < 0.2:
                opts["count"] = False
            ops.append(("match", toks, opts))
        elif kind == "evict":
            busy = tuple(int(p) for p in rng.integers(0, max(page, 1), 4))
            ops.append(("evict", int(rng.integers(1, 4)), busy))
        else:
            ops.append(("note", int(rng.integers(0, 3))))
    return 4, 16, ops


def _apply(cache, ops):
    out = []
    for op in ops:
        if op[0] == "insert":
            out.append(cache.insert(op[1], op[2]))
        elif op[0] == "match":
            out.append(cache.match(op[1], **op[2]))
        elif op[0] == "evict":
            busy = set(op[2])
            out.append(cache.evict(op[1], busy=lambda p: p in busy))
        else:
            cache.note(op[1])
        out.append((cache.stats, sorted(cache.indexed_pages())))
    return out


@pytest.mark.parametrize("case", sorted(TRIE_CASES) + ["random"])
def test_trie_matches_jax_trie(case):
    page_size, capacity, ops = (TRIE_CASES[case] if case != "random"
                                else _random_ops())
    ref = _apply(jc.RadixPrefixCache(page_size, capacity), ops)
    got = _apply(RadixPrefixCache(page_size, capacity), ops)
    assert got == ref
    if case == "windowed_hit_rate":
        assert got[-1][0]["recent_hit_rate"] == 0.0


# -- the engine against the JAX engine ------------------------------------------


@pytest.fixture(scope="module")
def models():
    return _models(pos="learned", page_size=16, num_pages=40, **CB_SMOKE)


def _drive(engine, specs, audit=False):
    """Submit ``specs`` one after another, each drained before the next
    (so each later one can hit what the earlier ones cached); returns
    the tokens in order."""
    out = []
    for prompt, max_new in specs:
        rid = engine.submit(prompt, max_new_tokens=max_new)
        done = {}
        while engine.busy:
            for req in engine.step():
                done[req.rid] = list(req.tokens)
            if audit:
                _check_page_invariants(engine)
        out.append(done[rid])
    return out


def _shared_specs(shared_len, seed=50):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, V, shared_len)
    return [(np.concatenate([shared, rng.integers(1, V, n)]), 6)
            for n in (7, 9, 40)]


@pytest.mark.parametrize("shared_len,prefill_chunk,depth", [
    (24, 0, 0), (32, 0, 1), (24, 32, 1)],
    ids=["cow_unchunked", "aligned_depth1", "cow_chunked_depth1"])
def test_radix_hit_matches_jax_engine(models, shared_len, prefill_chunk,
                                      depth):
    """Requests sharing a prefix (24 tokens: one full 16-token page and
    an 8-row copy-on-write clone; 32: two full pages), the last one
    longer than a piece: the JAX engine's tokens, prefill tokens and
    cache stats, the cache-off tokens, suffix-only prefill."""
    jmodel, params, tmodel = models
    specs = _shared_specs(shared_len)
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64, 128),
              prefill_chunk=prefill_chunk, pipeline_depth=depth)
    jeng = JaxEngine(jmodel, params, prefix_cache_size=24, **kw)
    ref = _drive(jeng, specs)
    eng = ContinuousEngine(tmodel, prefix_cache_size=24, **kw)
    assert _drive(eng, specs, audit=True) == ref
    assert _drive(ContinuousEngine(tmodel, **kw), specs) == ref
    st, jst = eng.stats, jeng.stats
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefill_tokens_computed"] == jst["prefill_tokens_computed"]
    assert st["prefix_cache"]["hits"] == 2
    assert st["prefill_tokens_computed"] == (
        sum(p.size for p, _ in specs) - 2 * shared_len)
    # idle: every referenced page is the trie's alone
    assert all(n == 1 for n in eng._page_refs.values())


@pytest.mark.parametrize("depth,prompt,resident", [
    (0, 231, True), (1, 231, False), (0, 236, False)],
    ids=["depth0_inserts", "depth1_skips", "depth0_skips"])
def test_radix_near_limit_guard_matches_jax(models, depth, prompt,
                                            resident):
    """``prompt + 20 + (depth + 1) * chunk >= max_seq_len`` (256) skips
    the insert: at 231 tokens only the pipelined engine's overshoot
    reaches the limit."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(57)
    specs = [(rng.integers(1, V, prompt), 20)]
    kw = dict(num_slots=1, chunk=3, prefix_cache_size=40,
              pipeline_depth=depth)
    jeng = JaxEngine(jmodel, params, **kw)
    ref = _drive(jeng, specs)
    eng = ContinuousEngine(tmodel, **kw)
    assert _drive(eng, specs, audit=True) == ref
    pages = eng.stats["prefix_cache"]["resident_pages"]
    assert pages == jeng.stats["prefix_cache"]["resident_pages"]
    assert (pages > 0) == resident


def test_warm_prefix_then_chunked_hit_matches_jax(models):
    jmodel, params, tmodel = models
    rng = np.random.default_rng(55)
    system = rng.integers(1, V, 40)
    p = np.concatenate([system, rng.integers(1, V, 50)])
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64),
              prefix_cache_size=32, prefill_chunk=32)
    engines = (JaxEngine(jmodel, params, **kw), ContinuousEngine(tmodel, **kw))
    outs = []
    for eng in engines:
        assert eng.warm_prefix(system) == 40
        assert eng.stats["prefix_cache"]["resident_pages"] == 3
        warm = eng.stats["prefill_tokens_computed"]
        outs.append(_drive(eng, [(p, 5)], audit=True))
        assert eng.stats["prefix_cache"]["hits"] == 1
        assert eng.stats["prefill_tokens_computed"] - warm == p.size - 40
        assert eng.warm_prefix(system) == 40  # resident: a no-op
        assert eng.stats["prefill_tokens_computed"] - warm == p.size - 40
        _check_page_invariants(eng)
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="prefix_cache_size"):
        ContinuousEngine(tmodel).warm_prefix(system)


def test_radix_refcounts_across_cancel_eviction_and_pipeline(models):
    """Cancel a hit-admitted request mid-decode and a radix-seeded
    piecewise admission mid-flight, under decode-ahead, then run a pool
    small enough that resident pages must be evicted: the audit stays
    green and every request's tokens equal the cache-off engine's."""
    _, _, tmodel = models
    small = tlm.CausalLM(dataclasses.replace(tmodel.cfg, kv_num_pages=8))
    small.load_state_dict(tmodel.state_dict())
    rng = np.random.default_rng(54)
    shared = rng.integers(1, V, 24)
    eng = ContinuousEngine(small, num_slots=2, chunk=3, buckets=(16, 32, 64),
                           prefix_cache_size=8, prefill_chunk=32,
                           pipeline_depth=1)
    _drive(eng, [(np.concatenate([shared, rng.integers(1, V, 5)]), 5)],
           audit=True)
    r1 = eng.submit(np.concatenate([shared, rng.integers(1, V, 6)]),
                    max_new_tokens=30)
    eng.step()
    eng.step()
    assert eng.cancel(r1)
    _check_page_invariants(eng)
    r2 = eng.submit(np.concatenate([shared, rng.integers(1, V, 60)]),
                    max_new_tokens=5)
    eng.step()
    assert eng.stats["admitting"] == r2 and eng._admitting["shared"]
    assert eng.cancel(r2)
    _check_page_invariants(eng)
    specs = [(rng.integers(1, V, 20), 8) for _ in range(5)]
    specs.append((np.concatenate([shared, rng.integers(1, V, 4)]), 6))
    got = _drive(eng, specs, audit=True)
    assert got == _drive(ContinuousEngine(small, num_slots=2, chunk=3,
                                          buckets=(16, 32, 64)), specs)
    assert eng.stats["prefix_cache"]["evictions"] > 0
    assert not eng._inflight_q


# -- the KV page handoff --------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_kv_handoff_between_packages_is_token_exact(kv_quant):
    """JAX exports 2 full pages of a warmed prefix, the blob crosses
    packages, the port imports it and a same-prefix request prefills
    its suffix only, token-exact against the JAX engine that exported;
    then the reverse direction."""
    jmodel, params, tmodel = _models(pos="learned", kv_quant=kv_quant,
                                     page_size=16, num_pages=24, **CB_SMOKE)
    rng = np.random.default_rng(90)
    prefix = rng.integers(1, V, 32)
    p = np.concatenate([prefix, rng.integers(1, V, 7)])
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64),
              prefix_cache_size=16, prefill_chunk=32)
    for src, dst in ((JaxEngine(jmodel, params, **kw),
                      ContinuousEngine(tmodel, **kw)),
                     (ContinuousEngine(tmodel, **kw),
                      JaxEngine(jmodel, params, **kw))):
        src.warm_prefix(prefix)
        export = src.export_prefix_pages(prefix)
        assert export["token_ids"] == [int(t) for t in prefix]
        assert export["layers"][0]["k_pages"].shape[0] == 2
        assert ("k_scale_pages" in export["layers"][0]) == kv_quant
        pack = tkv if isinstance(src, JaxEngine) else jkv
        unpack = jkv if pack is tkv else tkv
        back = unpack.unpack_kv_blob(pack.pack_kv_export(export))
        assert dst.import_prefix_pages(back["token_ids"],
                                       back["layers"]) == 32
        assert dst.import_prefix_pages(back["token_ids"],
                                       back["layers"]) == 32  # idempotent
        base = dst.stats["prefill_tokens_computed"]
        want = _drive(src, [(p, 6)])
        assert _drive(dst, [(p, 6)]) == want
        assert dst.stats["prefix_cache"]["hits"] == 1
        assert dst.stats["prefill_tokens_computed"] - base == p.size - 32
        for eng in (src, dst):
            _check_page_invariants(eng)


def test_kv_blob_codec_is_byte_compatible():
    """The same export packs to the same bytes in both packages, f32,
    int8 and a bf16 pool's pages alike, and each unpacks the other's."""
    rng = np.random.default_rng(3)
    bf16 = rng.standard_normal((2, 4, 2, 8)).astype(jnp.bfloat16)
    export = {"token_ids": list(range(8)), "page_size": 4, "layers": [
        {"k_pages": bf16, "v_pages": bf16 * 2},
        {"k_pages": rng.integers(-127, 127, (2, 4, 2, 8)).astype(np.int8),
         "v_pages": rng.integers(-127, 127, (2, 4, 2, 8)).astype(np.int8),
         "k_scale_pages": rng.random((2, 4, 2)).astype(np.float32),
         "v_scale_pages": rng.random((2, 4, 2)).astype(np.float32)}]}
    blob = tkv.pack_kv_export(export)
    assert blob == jkv.pack_kv_export(export)
    for a, b in ((tkv, jkv), (jkv, tkv)):
        back = a.unpack_kv_blob(b.pack_kv_export(export))
        assert back["token_ids"] == export["token_ids"]
        assert back["page_size"] == 4
        for got, want in zip(back["layers"], export["layers"]):
            assert sorted(got) == sorted(want)
            for key, leaf in want.items():
                ref = (leaf.astype(np.float32) if leaf.dtype.kind not in "iuf"
                       else leaf)
                assert got[key].dtype == ref.dtype
                np.testing.assert_array_equal(got[key], ref)
    for codec in (tkv, jkv):  # both refuse a malformed blob alike
        with pytest.raises(ValueError):
            codec.unpack_kv_blob(b"not an npz archive")


def test_bf16_pool_pages_cross_packages_losslessly():
    """A bf16 JAX engine's exported pages, packed by the JAX codec,
    install into a bf16 port pool and read back bit-equal; the port's
    export of them packs to the JAX export's bytes."""
    widths = dict(CB_SMOKE, num_kv_heads=2)
    cfg = CausalLMConfig(**widths, pos_embedding="learned",
                         dtype=jnp.bfloat16, kv_page_size=16, kv_num_pages=8)
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "bfloat16"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(params)).eval()
    prefix = np.random.default_rng(4).integers(1, V, 32)
    jeng = JaxEngine(jmodel, params, num_slots=1, chunk=2,
                     prefix_cache_size=8, prefill_chunk=32)
    jeng.warm_prefix(prefix)
    export = jeng.export_prefix_pages(prefix)
    assert export["layers"][0]["k_pages"].dtype == jnp.bfloat16
    back = tkv.unpack_kv_blob(jkv.pack_kv_export(export))
    teng = ContinuousEngine(tmodel, num_slots=1, chunk=2, prefix_cache_size=8)
    assert teng.import_prefix_pages(back["token_ids"], back["layers"]) == 32
    again = teng.export_prefix_pages(prefix)
    assert tkv.pack_kv_export(again) == jkv.pack_kv_export(export)


def test_wire_layer_order_matches_jax_walk():
    """At 11 layers the JAX engine walks layer_0, layer_1, layer_10,
    layer_2, ...: the port's transfers carry that order."""
    cfg = CausalLMConfig(vocab_size=32, hidden_size=16, num_layers=11,
                         num_heads=2, intermediate_size=32, max_seq_len=32,
                         dtype=jnp.float32, kv_page_size=16, kv_num_pages=2)
    model = CausalLM(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(0),
                                      jnp.ones((1, 8), jnp.int32))["params"])
    state = jc._paged_zeros_state(model, params, num_slots=1)
    names = []

    def visit(tree, path=()):
        if hasattr(tree, "keys"):
            if "k_pages" in tree:
                names.append(path[0])
                return
            for key in tree:
                visit(tree[key], path + (key,))

    visit(state.cache)  # the walk of the JAX engine's _map_paged_layers
    assert [int(n.split("_")[1]) for n in names] == tc.wire_layer_order(11)
    assert tc.wire_layer_order(11)[:4] == [0, 1, 10, 2]
