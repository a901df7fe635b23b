"""PyTorch port, the decode-ahead pipeline and the capturable decode chunk:
given the same submits at the same steps, the port's greedy tokens equal
the JAX ``ContinuousEngine``'s at the same ``pipeline_depth`` (1 and 2),
under staggered arrivals and eos; ``adaptive_chunk`` dispatches the JAX
engine's chunk sizes; a chunk and an admission leave the identity of
the slot state's tensors unchanged (what a CUDA graph replay needs);
greedy rows are unaffected by sampling rows and each sampled stream
depends only on its own seed, at every depth. The page audit of
``tests/test_radix_cache.py`` runs after every step. All in f32 on the
CPU, widths of the cb smoke configuration (hidden 64, 2 layers, vocab
512): tokens are compared exactly.
"""

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu_torch.train import continuous as tc
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from tests.test_radix_cache import _check_page_invariants
from tests.test_torch_engine import CB_SMOKE, JaxEngine, _models

torch.set_num_threads(1)

V = CB_SMOKE["vocab_size"]


@pytest.fixture(scope="module")
def models():
    return _models(pos="learned", page_size=16, num_pages=48, **CB_SMOKE)


def _spy_sizes(engine):
    sizes, inner = [], engine._dispatch_chunk

    def spy(size):
        sizes.append(int(size))
        return inner(size)

    engine._dispatch_chunk = spy
    return sizes


def _drive(engine, waves, audit=False, steps_between=2):
    """Submit each wave of ``(prompt, max_new)`` after ``steps_between``
    steps of the previous one (staggered arrivals), then drain; returns
    every request's tokens in submit order."""
    rids, done = [], {}
    for i, wave in enumerate(waves):
        rids += [engine.submit(p, max_new_tokens=m) for p, m in wave]
        for _ in range(steps_between if i + 1 < len(waves) else 0):
            for req in engine.step():
                done[req.rid] = list(req.tokens)
            if audit:
                _check_page_invariants(engine)
    while engine.busy:
        for req in engine.step():
            done[req.rid] = list(req.tokens)
        if audit:
            _check_page_invariants(engine)
    return [done[r] for r in rids]


def _waves(seed=7):
    rng = np.random.default_rng(seed)
    first = [(rng.integers(1, V, int(n)), int(m))
             for n, m in [(5, 12), (19, 3), (33, 8)]]
    second = [(rng.integers(1, V, int(n)), int(m))
              for n, m in [(7, 15), (11, 5)]]
    return [first, second]


@pytest.mark.parametrize("depth,eos", [(1, False), (2, False), (1, True)],
                         ids=["depth1", "depth2", "depth1_eos"])
def test_pipeline_matches_jax_engine(models, depth, eos):
    jmodel, params, tmodel = models
    waves = _waves()
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64),
              pipeline_depth=depth)
    if eos:
        plain = _drive(JaxEngine(jmodel, params, **kw), waves)
        kw["eos_token_id"] = plain[0][2]  # a token the first one emits
    ref = _drive(JaxEngine(jmodel, params, **kw), waves)
    eng = ContinuousEngine(tmodel, **kw)
    assert _drive(eng, waves, audit=True) == ref
    if eos:
        assert ref[0][-1] == kw["eos_token_id"] and len(ref[0]) == 3
    assert not eng._inflight_q and not eng._page_refs
    # the serial port engine gives the same tokens: depth moves only
    # where frees and admissions land
    serial = ContinuousEngine(tmodel, **dict(kw, pipeline_depth=0))
    assert _drive(serial, waves) == ref


ADAPTIVE = {
    # the JAX engine's three adaptive-chunk cases (tests/test_continuous.py
    # :623, :647, :761): bucketed sizes under decode-ahead, the skipped
    # dead dispatch at depth 2, eos on the unpipelined loop
    "bucketed": dict(kw=dict(num_slots=2, chunk=32, pipeline_depth=1),
                     specs=[(5, 37), (19, 9), (33, 21), (7, 12), (11, 30)]),
    "skip_dead": dict(kw=dict(num_slots=1, chunk=32, pipeline_depth=2),
                      specs=[(5, 16)]),
    "eos_unpipelined": dict(kw=dict(num_slots=1, chunk=16), specs=[(8, 12)],
                            eos=True),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_adaptive_chunk_sizes_match_jax(models, case):
    jmodel, params, tmodel = models
    spec = ADAPTIVE[case]
    rng = np.random.default_rng(23)
    specs = [(rng.integers(1, V, n), m) for n, m in spec["specs"]]
    kw = dict(spec["kw"], buckets=(16, 32, 64), adaptive_chunk=True)
    if spec.get("eos"):
        plain = _drive(JaxEngine(jmodel, params, **kw), [specs])
        kw["eos_token_id"] = plain[0][2]
    jeng = JaxEngine(jmodel, params, **kw)
    jsizes = _spy_sizes(jeng)
    ref = _drive(jeng, [specs])
    eng = ContinuousEngine(tmodel, **kw)
    sizes = _spy_sizes(eng)
    assert _drive(eng, [specs], audit=True) == ref
    assert sizes == jsizes
    assert all(s in (8, 16, 32) for s in sizes)
    if case == "skip_dead":
        assert sizes == [16]  # one aligned dispatch, the rest skipped
    if case == "bucketed":
        assert min(sizes) < 32


def _state_identity(eng):
    st = eng._state
    return [(id(t), t.data_ptr()) for t in (
        st.positions, st.last_logits, st.live, st.temps, st.topps, st.keys,
        st.draws, st.cache.block_table)]


def test_chunk_and_admission_keep_state_identity(models):
    """Every tensor a captured chunk reads or writes keeps its storage
    through batched and solo admission, a chunked-prefill activation,
    decode chunks and frees."""
    _, _, tmodel = models
    eng = ContinuousEngine(tmodel, num_slots=3, chunk=4, buckets=(16, 32),
                           prefill_chunk=32, pipeline_depth=1)
    before = _state_identity(eng)
    rng = np.random.default_rng(3)
    for n in (5, 9, 70, 12):  # a batch of two, a piecewise admission
        eng.submit(rng.integers(1, V, n), max_new_tokens=6,
                   temperature=0.7 if n == 9 else 0.0, seed=n)
    list(eng.run_until_drained())
    assert eng.stats["batch_admits"] >= 2
    assert eng.stats["prefill_chunks"] >= 3
    assert _state_identity(eng) == before


def test_greedy_rows_unaffected_by_sampling_rows(models):
    """Greedy requests decode the same tokens beside sampled ones as
    alone; a sampled request decodes the same tokens whatever runs
    beside it, in whichever slot, and another seed changes them."""
    _, _, tmodel = models
    rng = np.random.default_rng(5)
    greedy = [rng.integers(1, V, 9), rng.integers(1, V, 14)]
    sampled = rng.integers(1, V, 11)

    def run(jobs, depth=0, slots=3):
        eng = ContinuousEngine(tmodel, num_slots=slots, chunk=4,
                               buckets=(16, 32), pipeline_depth=depth)
        rids = [eng.submit(p, max_new_tokens=10, temperature=t, top_p=0.9,
                           seed=s) for p, t, s in jobs]
        out = dict(eng.run_until_drained())
        return [out[r] for r in rids]

    alone = run([(g, 0.0, 0) for g in greedy])
    mixed = run([(greedy[0], 0.0, 0), (sampled, 0.9, 5),
                 (greedy[1], 0.0, 0)])
    assert [mixed[0], mixed[2]] == alone
    solo = run([(sampled, 0.9, 5)], slots=1)[0]
    assert mixed[1] == solo  # another slot, other rows beside it
    beside = run([(sampled, 0.9, 5), (greedy[0], 0.6, 77)])
    assert beside[0] == solo
    assert run([(sampled, 0.9, 6)], slots=1)[0] != solo
    for depth in (1, 2):  # the stream is the same at every depth
        assert run([(greedy[0], 0.0, 0), (sampled, 0.9, 5),
                    (greedy[1], 0.0, 0)], depth=depth) == mixed


def test_sampling_chunk_on_greedy_rows_is_the_greedy_chunk(models):
    """The sampling math runs over every row, but a temperature-0 row
    takes the argmax: its tokens are bit-identical to a greedy chunk's."""
    _, _, tmodel = models
    logits = torch.randn(3, V, generator=torch.Generator().manual_seed(1))
    eng = ContinuousEngine(tmodel, num_slots=3, chunk=4)
    st = eng._state
    st.temps.copy_(torch.tensor([0.0, 0.8, 0.0]))
    st.keys.copy_(torch.tensor([tc._seed_key(s) for s in (1, 2, 3)]))
    greedy = tc._pick_tokens(logits, st, sampling=False)
    mixed = tc._pick_tokens(logits, st, sampling=True)
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
    st.temps.zero_()
    assert torch.equal(tc._pick_tokens(logits, st, sampling=True), greedy)


def test_seed_stream_depends_on_seed_and_step_only(models):
    _, _, tmodel = models
    eng = ContinuousEngine(tmodel, num_slots=4, chunk=4)
    st = eng._state
    st.keys.copy_(torch.tensor([tc._seed_key(s) for s in (9, 9, 10, 9)]))
    st.draws.copy_(torch.tensor([0, 0, 0, 1]))
    g = tc._gumbel(st)
    assert torch.equal(g[0], g[1])          # same seed, same step
    assert not torch.equal(g[0], g[2])      # another seed
    assert not torch.equal(g[0], g[3])      # another step
    assert torch.isfinite(g).all()
    assert tc._seed_key(2 ** 64 + 9) == tc._seed_key(9)


def test_cancel_in_flight_and_quiesce(models):
    """A request cancelled while its chunk is in flight is skipped at
    collect; ``quiesce`` settles every in-flight chunk and the engine
    resumes with the tokens of an engine never quiesced; an in-flight
    chunk's requests are outstanding."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(9)
    keep, drop = rng.integers(1, V, 9), rng.integers(1, V, 9)
    kw = dict(num_slots=2, chunk=2, buckets=(16,), pipeline_depth=1)
    jeng = JaxEngine(jmodel, params, **kw)
    jkeep = jeng.submit(keep, max_new_tokens=10)
    jdrop = jeng.submit(drop, max_new_tokens=10)
    jeng.step()
    jeng.cancel(jdrop)
    ref = dict(jeng.run_until_drained())
    eng = ContinuousEngine(tmodel, **kw)
    r_keep = eng.submit(keep, max_new_tokens=10)
    r_drop = eng.submit(drop, max_new_tokens=10)
    eng.step()  # dispatches chunk 1, nothing collected yet
    assert eng._inflight_q
    assert {r.rid for r in eng.outstanding_requests()} == {r_keep, r_drop}
    assert eng.cancel(r_drop)
    finished = {r.rid: list(r.tokens) for r in eng.quiesce()}
    assert not eng._inflight_q and eng.quiesce() == []
    finished.update(dict(eng.run_until_drained()))
    assert r_drop not in finished
    assert finished[r_keep] == ref[jkeep]
    _check_page_invariants(eng)
    assert not eng._page_refs


def test_pipeline_composes_with_chunked_prefill_and_budget(models):
    """Decode-ahead with pieces under a step-token budget: the JAX
    engine's tokens and chunk sizes."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(21)
    specs = [(rng.integers(1, V, 16), 8), (rng.integers(1, V, 100), 8),
             (rng.integers(1, V, 16), 8)]
    kw = dict(num_slots=2, chunk=4, prefill_chunk=32, step_token_budget=40,
              pipeline_depth=1)
    jeng = JaxEngine(jmodel, params, **kw)
    jsizes = _spy_sizes(jeng)
    ref = _drive(jeng, [specs])
    eng = ContinuousEngine(tmodel, **kw)
    sizes = _spy_sizes(eng)
    assert _drive(eng, [specs], audit=True) == ref
    assert sizes == jsizes
    assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]
