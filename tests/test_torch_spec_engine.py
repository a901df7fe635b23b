"""PyTorch port, speculative decoding in the slot engine: under the same
submits at the same steps, the port's ``ContinuousEngine(...,
spec_tokens=k, draft_model=...)`` gives the JAX ``ContinuousEngine``'s
tokens and per-request accept counts exactly (f32 on the CPU, the
widths of ``tests/test_spec_engine.py``, weights carried across with
``params_from_flax``) — a self-draft and a separate draft, staggered
arrivals and eos inside the window, chunked prefill under a step budget,
decode-ahead depths 1 and 2, adaptive chunks, the radix copy-on-write
case, the JAX fixture's trained pair — with the page audit of
``tests/test_radix_cache.py`` after every step; cancel releases pages,
greedy rows are unaffected by sampled rows, a sampled stream depends on
its seed alone, and the slot state and the draft cache keep their
storage across spec chunks and admissions (what a replay needs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.models import speculative as jspec
from pyspark_tf_gke_tpu.models.causal_lm import CausalLM as JaxLM
from pyspark_tf_gke_tpu.models.causal_lm import CausalLMConfig as JaxConfig
from pyspark_tf_gke_tpu.train import spec_fixture as jfix
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models import speculative as tspec
from pyspark_tf_gke_tpu_torch.train import spec_fixture as tfix
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from tests.test_radix_cache import _check_page_invariants
from tests.test_torch_spec import (DRAFT, K, TARGET, V, _pair, _port,
                                   _prompt)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    jm, _, params, tm, _ = _pair(DRAFT, 7)
    return jm, params, tm


def _drive(engine, waves, audit=False, steps_between=2):
    """Submit each wave of ``(prompt, max_new)`` after ``steps_between``
    steps of the previous one, then drain; returns ``(tokens,
    spec_proposed, spec_accepted)`` of every request in submit order."""
    rids, done = [], {}

    def step():
        for req in engine.step():
            done[req.rid] = (list(req.tokens), req.spec_proposed,
                             req.spec_accepted)
        if audit:
            _check_page_invariants(engine)

    for i, wave in enumerate(waves):
        rids += [engine.submit(p, max_new_tokens=m) for p, m in wave]
        for _ in range(steps_between if i + 1 < len(waves) else 0):
            step()
    while engine.busy:
        step()
    return [done[r] for r in rids]


def _waves(seed=1):
    rng = np.random.default_rng(seed)
    first = [(_prompt(rng, n), m) for n, m in [(5, 12), (19, 3), (17, 8)]]
    second = [(_prompt(rng, n), m) for n, m in [(7, 15), (11, 5)]]
    return [first, second]


ENGINE_CASES = {
    "self_draft": dict(kw=dict(num_slots=2, chunk=6, buckets=(16, 32))),
    "separate_draft": dict(kw=dict(num_slots=2, chunk=6, buckets=(16, 32)),
                           draft=True),
    "eos_in_window": dict(kw=dict(num_slots=2, chunk=8, buckets=(16, 32)),
                          eos=True),
    "chunked_budget": dict(kw=dict(num_slots=2, chunk=8,
                                   buckets=(16, 32, 64, 128),
                                   prefill_chunk=32, step_token_budget=40),
                           long=True),
    "depth1": dict(kw=dict(num_slots=2, chunk=6, buckets=(16, 32),
                           pipeline_depth=1), draft=True),
    "depth2": dict(kw=dict(num_slots=2, chunk=6, buckets=(16, 32),
                           pipeline_depth=2)),
    "adaptive": dict(kw=dict(num_slots=2, chunk=16, buckets=(16, 32),
                             pipeline_depth=1, adaptive_chunk=True)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_spec_engine_matches_jax_engine(target, draft, case):
    _, jpaged, tparams, _, tpaged = target
    jd, dparams, td = draft
    spec = ENGINE_CASES[case]
    kw = dict(spec["kw"], spec_tokens=K)
    jkw, tkw = dict(kw), dict(kw)
    if spec.get("draft"):
        jkw.update(draft_model=jd, draft_params=dparams)
        tkw.update(draft_model=td)
    waves = _waves()
    if spec.get("long"):
        rng = np.random.default_rng(19)
        waves = [[(_prompt(rng, 6), 12), (_prompt(rng, 100), 5)],
                 [(_prompt(rng, 70), 6)]]
    if spec.get("eos"):
        plain = _drive(JaxEngine(jpaged, tparams, **jkw), waves)
        jkw["eos_token_id"] = tkw["eos_token_id"] = plain[0][0][2]
    ref = _drive(JaxEngine(jpaged, tparams, **jkw), waves)
    eng = ContinuousEngine(tpaged, **tkw)
    got = _drive(eng, waves, audit=True)
    assert got == ref
    assert not eng._page_refs and not eng._inflight_q
    st = eng.stats["spec"]
    assert st["self_draft"] == (not spec.get("draft"))
    assert st["proposed"] == sum(r[1] for r in got) > 0
    if spec.get("eos"):
        assert got[0][0][-1] == tkw["eos_token_id"] and len(got[0][0]) == 3
    if spec.get("long"):
        assert eng.stats["prefill_chunks"] >= 4
    if not spec.get("draft"):
        assert st["accepted"] == st["proposed"]  # a self-draft agrees


def test_spec_radix_copy_on_write_matches_jax(target):
    """A radix hit shares trie pages and clones the partly filled tail
    page BEFORE the first (k+1)-row verify write of the new slot; both
    hits and a third matcher stay exact, the audit green every step."""
    jm, jpaged, tparams, tm, tpaged = target
    rng = np.random.default_rng(5)
    shared = _prompt(rng, 24)  # 24 % 16 != 0: a partial tail page
    p1, p2, p3 = (np.concatenate([shared, _prompt(rng, n)])
                  for n in (5, 8, 6))
    kw = dict(num_slots=2, chunk=6, buckets=(16, 32, 64),
              prefix_cache_size=32, spec_tokens=K)
    jeng, eng = JaxEngine(jpaged, tparams, **kw), ContinuousEngine(tpaged,
                                                                   **kw)
    for p in (p1, p2, p3):
        ref = _drive(jeng, [[(p, 6)]])
        assert _drive(eng, [[(p, 6)]], audit=True) == ref
        want = tlm.generate(tm, p[None], 6)[0, p.size:].tolist()
        assert ref[0][0] == want
    assert eng.stats["prefix_cache"] == jeng.stats["prefix_cache"]
    assert eng.stats["prefix_cache"]["hits"] == 2


def test_spec_request_filling_max_seq_len_is_exact(target):
    """A verify of a request whose prompt and budget fill max_seq_len
    runs past the table's extent: those rows go to the trash page, never
    over the live rows of the slot's last page."""
    _, _, _, tm, tpaged = target
    rng = np.random.default_rng(8)
    prompt = _prompt(rng, 230)
    eng = ContinuousEngine(tpaged, num_slots=1, chunk=8, spec_tokens=K)
    got = _drive(eng, [[(prompt, 26)]], audit=True)[0][0]
    assert got == tlm.generate(tm, prompt[None], 26)[0, 230:].tolist()


def test_spec_cancel_releases_pages(target):
    _, _, _, _, tpaged = target
    rng = np.random.default_rng(31)
    eng = ContinuousEngine(tpaged, num_slots=2, chunk=4, buckets=(16,),
                           spec_tokens=2, pipeline_depth=1)
    rc = eng.submit(_prompt(rng, 6), max_new_tokens=50)
    keep = eng.submit(_prompt(rng, 6), max_new_tokens=9)
    eng.step()
    assert eng.cancel(rc)
    done = {}
    while eng.busy:
        for r in eng.step():
            done[r.rid] = r
        _check_page_invariants(eng)
    assert set(done) == {keep} and len(done[keep].tokens) == 9
    assert eng.stats["paged"]["pages_in_use"] == 0 and not eng._page_refs


def test_spec_sampling_greedy_rows_isolated_and_seeded(target, draft):
    """Sampled rows ride the rejection rule with their own counter-based
    draws: greedy rows beside them keep the greedy tokens, a sampled
    stream is the same for the same seed whatever runs beside it, and
    another seed changes it."""
    _, _, _, tm, tpaged = target
    _, _, td = draft
    rng = np.random.default_rng(29)
    pg, pt = _prompt(rng, 9), _prompt(rng, 9)

    def run(jobs, slots=2, depth=0):
        eng = ContinuousEngine(tpaged, num_slots=slots, chunk=6,
                               buckets=(16, 32), spec_tokens=K,
                               draft_model=td, pipeline_depth=depth)
        rids = [eng.submit(p, max_new_tokens=12, temperature=t, top_p=0.9,
                           seed=s) for p, t, s in jobs]
        out = dict(eng.run_until_drained())
        return [out[r] for r in rids], eng.stats["spec"]

    (g1, t1), st = run([(pg, 0.0, 0), (pt, 0.8, 5)])
    assert g1 == tlm.generate(tm, pg[None], 12)[0, 9:].tolist()
    assert len(t1) == 12 and all(0 <= t < V for t in t1)
    assert 0 <= st["accepted"] <= st["proposed"]
    assert run([(pt, 0.8, 5)], slots=1)[0] == [t1]
    assert run([(pt, 0.8, 5), (pg, 0.0, 0)], depth=1)[0] == [t1, g1]
    assert run([(pt, 0.8, 6)], slots=1)[0] != [t1]


def test_spec_chunk_and_admission_keep_tensor_identity(target, draft):
    """Every tensor a captured spec chunk reads or writes — the slot
    state and the draft cache — keeps its storage through batched, solo
    and piecewise admissions, spec chunks and frees."""
    _, _, _, _, tpaged = target
    _, _, td = draft
    eng = ContinuousEngine(tpaged, num_slots=3, chunk=8, buckets=(16, 32),
                           prefill_chunk=32, spec_tokens=K, draft_model=td,
                           pipeline_depth=1)

    def identity():
        st = eng._state
        tensors = [st.positions, st.last_logits, st.live, st.temps,
                   st.topps, st.keys, st.draws, st.cache.block_table]
        dc = eng._draft.cache
        return [(id(t), t.data_ptr()) for t in
                tensors + dc.k + dc.v + (dc.k_scale or [])]

    before = identity()
    rng = np.random.default_rng(3)
    for n in (5, 9, 70, 12):  # a batch of two, a piecewise admission
        eng.submit(_prompt(rng, n), max_new_tokens=6,
                   temperature=0.7 if n == 9 else 0.0, seed=n)
    list(eng.run_until_drained())
    assert eng.stats["batch_admits"] >= 2 and eng.stats["prefill_chunks"] >= 3
    assert eng.stats["spec"]["rounds"] > 0
    assert identity() == before


def test_spec_engine_refusals(target):
    _, _, _, _, tpaged = target
    with pytest.raises(ValueError, match="spec_tokens must be >= 0"):
        ContinuousEngine(tpaged, spec_tokens=-1)
    other = tlm.CausalLM(dataclasses.replace(tpaged.cfg, vocab_size=64,
                                             kv_num_pages=None))
    with pytest.raises(ValueError, match="draft vocab 64 != target vocab"):
        ContinuousEngine(tpaged, spec_tokens=2, draft_model=other)
    eng = ContinuousEngine(tpaged, spec_tokens=0, draft_model=tpaged)
    assert "spec" not in eng.stats and eng.spec_accept_rate() == 0.0


@pytest.fixture(scope="module")
def trained():
    """The JAX fixture's pair at a reduced step count, carried across."""
    common = dict(vocab_size=259, intermediate_size=128, max_seq_len=256,
                  dtype=jnp.float32)
    tcfg = JaxConfig(hidden_size=64, num_layers=2, num_heads=4, **common)
    dcfg = JaxConfig(hidden_size=32, num_layers=1, num_heads=2,
                     **{**common, "intermediate_size": 64})
    rows = jfix._pack_rows(64, n_rows=32, seed=0, skew=0.8)
    jt, jd = JaxLM(tcfg), JaxLM(dcfg)
    tparams = jax.device_get(jfix._train_lm(jt, rows, 300, lr=3e-3, seed=0))
    dparams = jax.device_get(jfix._train_lm(jd, rows, 300, lr=3e-3, seed=1))
    ptcfg = dataclasses.replace(tcfg, kv_page_size=32, kv_num_pages=16)
    return (jt, JaxLM(ptcfg), tparams, jd, dparams, _port(tcfg, tparams),
            _port(ptcfg, tparams), _port(dcfg, dparams))


def test_trained_pair_accepts_as_the_jax_pair(trained):
    jt, jpaged, tparams, jd, dparams, tt, tpaged, td = trained
    prompts = tfix._pack_rows(16, 4, seed=5, skew=0.8)
    want, jstats = jspec.speculative_generate(
        jt, tparams, jd, dparams, jnp.asarray(prompts[:1]), 48, gamma=4,
        return_stats=True)
    for loop in (True, False):
        got, stats = tspec.speculative_generate(
            tt, td, prompts[:1], 48, gamma=4, return_stats=True,
            device_loop=loop)
        assert got.tolist() == np.asarray(want).tolist()
        assert stats == jstats
    assert 0 < jstats["accepted"] < jstats["proposed"]
    kw = dict(num_slots=2, chunk=16, adaptive_chunk=True, spec_tokens=5)
    jeng = JaxEngine(jpaged, tparams, draft_model=jd, draft_params=dparams,
                     **kw)
    ref = _drive(jeng, [[(p, 32) for p in prompts]])
    eng = ContinuousEngine(tpaged, draft_model=td, **kw)
    assert _drive(eng, [[(p, 32) for p in prompts]], audit=True) == ref
    spec = eng.stats["spec"]
    assert spec == jeng.stats["spec"]
    assert 0 < spec["accept_rate"] < 1
