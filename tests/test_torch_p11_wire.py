"""PyTorch port, the multi-process serve wire without a second process
(``pyspark_tf_gke_tpu_torch/train/serving.py``):

* placements: ``serving_shardings`` gives the JAX ``serving_shardings``'
  specs on tp=2 and tp=4 fake devices, int8 scales and a 259-token
  vocabulary (left whole at tp=2) included;
* header sequence: for the same submission script, the port engine's
  announced stream (every header AND every payload) equals the JAX
  engine's, recorded through each package's ``_bcast`` seam: chunked
  prefill pieces, a radix hit's copy-on-write, a KV page import, sampled
  lanes, decode-ahead (``pipeline_depth`` 1 and its collects) and spec
  chunks with their draft payloads;
* replay: rank 0's recorded stream fed to the port's
  ``serve_worker_loop`` is consumed to the last array, and the worker's
  replica ends with rank 0's page pools, block table, fills, carried
  logits, live flags and draft cache, bit for bit;
* failure rules: a failed slot-engine op poisons the replica, the next
  one exits with 14 unless ``OP_CB_RESET`` heals it first.

Everything is f32 on the CPU in one process.
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
from pyspark_tf_gke_tpu.train import serving as jserving
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train import continuous as tcont
from pyspark_tf_gke_tpu_torch.train import serving as tserving
from pyspark_tf_gke_tpu_torch.train.export import (_flatten,
                                                   config_from_dict,
                                                   params_from_flax)

torch.set_num_threads(1)

TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=128,
            dtype=jnp.float32, kv_page_size=16, kv_num_pages=24)


def _pair(quantize: bool = False, **over):
    cfg = CausalLMConfig(**{**TINY, **over})
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(3), jnp.ones((1, 8), jnp.int32))["params"]))
    if quantize:
        params = jax.device_get(jquant.quantize_tree(params, min_size=512))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(params)).eval()
    return jmodel, params, tmodel


# -- placements ----------------------------------------------------------------


def _strip(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_specs(tree) -> dict:
    out = {}
    for path, leaf in _flatten(tree).items():
        if isinstance(leaf, jquant.QTensor):
            out[path] = (_strip(leaf.q.spec), _strip(leaf.scale.spec))
        else:
            out[path] = _strip(leaf.spec)
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("vocab", [96, 259])
def test_serving_shardings_match_jax(tp, quantize, vocab):
    jmodel, params, tmodel = _pair(quantize, vocab_size=vocab,
                                   num_kv_heads=4)
    jmesh = jmake_mesh({"tp": tp}, jax.devices()[:tp])
    want = _jax_specs(jserving.serving_shardings(jmodel, params, jmesh))
    got = {path: ((_strip(s.q), _strip(s.scale))
                  if isinstance(s, tserving.QSpec) else _strip(s))
           for path, s in tserving.serving_shardings(
               tmodel, {"tp": tp}).items()}
    assert got == want
    head = got["lm_head/kernel"]
    head = head[0] if quantize else head
    # a vocabulary the extent does not divide stays whole (fit_spec)
    assert ("tp" in head) == (vocab % tp == 0)
    if quantize:  # scales: split with columns, whole with rows
        assert got["layer_0/attention/query/kernel"][1] == ("tp",)
        assert "tp" not in got["layer_0/attention/out/kernel"][1]


# -- the announced stream --------------------------------------------------------


def _record(monkeypatch, module) -> list:
    stream = []

    def bcast(x):
        arr = np.ascontiguousarray(np.asarray(x))
        stream.append(arr.copy())
        return arr

    monkeypatch.setattr(module, "_bcast", bcast)
    return stream


CASES = {
    # chunked pieces, a warmed prefix hit ending inside a page (its
    # copy-on-write), a KV page import then a hit on it, a sampled lane
    "chunked_cow_xfer": dict(engine=dict(prefill_chunk=32,
                                         prefix_cache_size=16)),
    # decode-ahead: deferred chunks and their collects
    "depth1": dict(engine=dict(pipeline_depth=1)),
    # spec chunks (self-draft) and the admits' draft payloads
    "spec": dict(engine=dict(spec_tokens=2)),
}


def _script(case: str, engine, rng) -> dict:
    sys_prompt = rng.integers(1, 97, 20)
    blob_tokens = rng.integers(1, 97, 32)
    out = {}
    if case == "chunked_cow_xfer":
        engine.warm_prefix(sys_prompt)
        layers = [{"k_pages": rng.standard_normal((2, 16, 2, 8)).astype(
                       np.float32) * 0.1,
                   "v_pages": rng.standard_normal((2, 16, 2, 8)).astype(
                       np.float32) * 0.1} for _ in range(2)]
        out["import"] = engine.import_prefix_pages(blob_tokens, layers)
    specs = [(np.concatenate([sys_prompt, rng.integers(1, 97, 5)]), 6, {}),
             (rng.integers(1, 97, 50), 5, {}),
             (rng.integers(1, 97, 9), 7, dict(temperature=0.8, seed=11)),
             (np.concatenate([blob_tokens, rng.integers(1, 97, 3)]), 4, {})]
    rids = [engine.submit(p, max_new_tokens=m, **kw) for p, m, kw in specs]
    results = dict(engine.run_until_drained())
    out["tokens"] = [results[r] for r in rids]
    return out


def _port_engine(tmodel, case):
    return tcont.ContinuousEngine(tmodel, num_slots=2, chunk=3,
                                  buckets=(16, 32, 64), announce=True,
                                  **CASES[case]["engine"])


@pytest.mark.parametrize("case", list(CASES))
def test_header_sequence_matches_jax_engine(case, monkeypatch):
    jmodel, params, tmodel = _pair()
    jstream = _record(monkeypatch, jserving)
    jeng = JaxEngine(jmodel, params, num_slots=2, chunk=3,
                     buckets=(16, 32, 64), announce=True,
                     **CASES[case]["engine"])
    jout = _script(case, jeng, np.random.default_rng(5))
    tstream = _record(monkeypatch, tserving)
    teng = _port_engine(tmodel, case)
    tout = _script(case, teng, np.random.default_rng(5))
    # greedy tokens equal; the sampled request (index 2) draws from the
    # port's counter-based lanes, not JAX's threefry stream
    for out in (tout, jout):
        del out["tokens"][2]
    assert tout == jout
    headers = [a for a in tstream if a.shape == (8,) and a.dtype == np.int32]
    ops = {int(h[0]) for h in headers}
    assert {tserving.OP_CB_ADMIT, tserving.OP_CB_CHUNK,
            tserving.OP_CB_FREE} <= ops
    if case == "depth1":
        assert tserving.OP_CB_COLLECT in ops
    if case == "chunked_cow_xfer":
        assert tserving.OP_KV_XFER in ops
        flags = [int(h[7]) for h in headers if h[0] == tserving.OP_CB_ADMIT]
        assert any(f & 8 for f in flags) and any(f & 4 for f in flags)
    if case == "spec":
        assert any(h[0] == tserving.OP_CB_CHUNK and h[7] == 2
                   for h in headers)
    assert len(tstream) == len(jstream)
    for i, (t, j) in enumerate(zip(tstream, jstream)):
        assert t.dtype == j.dtype and t.shape == j.shape, i
        np.testing.assert_array_equal(t, j, err_msg=f"broadcast {i}")


def _device_tensors(dev) -> dict:
    st = dev.state
    out = {"positions": st.positions, "logits": st.last_logits,
           "live": st.live, "temps": st.temps, "keys": st.keys,
           "draws": st.draws, "table": st.cache.block_table}
    for i in range(len(st.cache._k)):
        out[f"k{i}"], out[f"v{i}"] = st.cache._k[i], st.cache._v[i]
    if dev.draft is not None:
        for i, t in enumerate(dev.draft.cache.k + dev.draft.cache.v):
            out[f"draft{i}"] = t
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_stream_replays_on_worker(case, monkeypatch):
    _, _, tmodel = _pair()
    stream = _record(monkeypatch, tserving)
    eng = _port_engine(tmodel, case)
    _script(case, eng, np.random.default_rng(6))
    tserving.announce_shutdown()
    replay = list(stream)

    def replay_bcast(x):
        got = replay.pop(0)
        want = np.asarray(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        return got

    replicas = []

    class Recorded(tcont.SlotDeviceState):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            replicas.append(self)

    monkeypatch.setattr(tserving, "_bcast", replay_bcast)
    monkeypatch.setattr(tcont, "SlotDeviceState", Recorded)
    served = tserving.serve_worker_loop(tmodel)
    assert not replay, f"{len(replay)} broadcasts never consumed"
    assert served > 0 and len(replicas) == 1
    mine, theirs = _device_tensors(eng._device), _device_tensors(replicas[0])
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert torch.equal(mine[key], theirs[key]), key


# -- the failure rules -------------------------------------------------------------


def _feed(monkeypatch, arrays):
    queue = [np.asarray(a) for a in arrays]

    def bcast(x):
        return queue.pop(0)

    monkeypatch.setattr(tserving, "_bcast", bcast)
    return queue


def test_poisoned_replica_exits_14_and_reset_heals(monkeypatch):
    _, _, tmodel = _pair()
    collect = tserving._header(tserving.OP_CB_COLLECT, 2)
    free = tserving._header(tserving.OP_CB_FREE, 2, 0, 0, 0, 1)
    shutdown = tserving._header(tserving.OP_SHUTDOWN)
    # a collect with no deferred chunk fails: the next op exits 14
    left = _feed(monkeypatch, [collect, free, shutdown])
    with pytest.raises(SystemExit) as exc:
        tserving.serve_worker_loop(tmodel)
    assert exc.value.code == 14 and len(left) == 1
    # the same failure healed by OP_CB_RESET: the loop runs on
    left = _feed(monkeypatch, [collect, tserving._header(
        tserving.OP_CB_RESET), free, shutdown])
    assert tserving.serve_worker_loop(tmodel) == 0 and not left
    # a failing whole-batch request is logged and the loop continues
    # (rank 0 answers it with the same error)
    too_long = tserving._header(tserving.OP_GENERATE, 1, 4, 500, -1, 0, -1,
                                0)
    left = _feed(monkeypatch, [too_long, np.ones((1, 4), np.int32),
                               shutdown])
    assert tserving.serve_worker_loop(tmodel) == 1 and not left
