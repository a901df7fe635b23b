"""PyTorch port, int8 weights kept resident: K6's plain version, and its
grouped call (query/key/value, SwiGLU's gate/input), against the JAX
package's ``QTensor.dequantize()`` followed by the product (bf16 and
f32); ``int8_plan`` and the grouped launch through a
recording library that refuses what ``csrc/int8_matmul.cu`` refuses,
tails included; the K6 launches a decode step reckoned from the model's
Dense groups; a model loaded from an
int8 tree or bundle holds int8 kernels and tables with their scales and
no float copy of them (its bytes are ``tree_bytes``, equal to the JAX
package's); the embedding row gather equals dequantize-then-gather bit
for bit; and on an int8 tree ``generate``, the engine (paged and dense)
and ``beam_search`` equal the JAX package's, with the in-loop decode
logits within 1e-4 (f32 on the CPU, the same arithmetic in another
summation order).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import beam_search as jbeam
from pyspark_tf_gke_tpu.models.causal_lm import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.models.causal_lm import generate as jgenerate
from pyspark_tf_gke_tpu.ops import quant as jquant
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search
from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im
from pyspark_tf_gke_tpu_torch.ops import kernels
from pyspark_tf_gke_tpu_torch.ops.quant import (QTensor, gather_rows,
                                                tree_bytes)
from pyspark_tf_gke_tpu_torch.train import export as texport
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)

torch.set_num_threads(1)

# small enough for the CPU, every 2-D leaf quantized (min_size 512)
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, max_seq_len=128,
            dtype=jnp.float32, pos_embedding="learned")
DECODE_ATOL = 1e-4  # f32 logits of O(1): summation order only


def _int8_pair(**over):
    """``(jax model, int8 params, port model)``: one JAX-quantized tree,
    carried into the port with ``params_from_flax``."""
    cfg = CausalLMConfig(**{**TINY, **over})
    jmodel = CausalLM(cfg)
    params = nn.meta.unbox(jmodel.init(jax.random.key(2),
                                       jnp.ones((1, 8), jnp.int32))["params"])
    qparams = jax.device_get(jquant.quantize_tree(params, min_size=512))
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tmodel = tlm.CausalLM(config_from_dict(fields))
    tmodel.load_params(params_from_flax(qparams)).eval()
    return jmodel, qparams, tmodel


@pytest.fixture(scope="module")
def dense():
    return _int8_pair()


# -- K6: the plain version and the plan ---------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(32, 64), (96, 259), (64, 32)])
def test_int8_matmul_plain_matches_jax_dequantize_then_dot(dtype, k, n):
    """``int8_matmul_plain`` against ``QTensor.dequantize()`` cast to the
    compute dtype and ``jnp.dot``: the dequantized weights are equal bit
    for bit, the products f32 within 1e-5 relative (summation order), bf16
    within one bf16 rounding (rtol 1e-2) of outputs of O(1)."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((7, k)).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w))
    jdt = jnp.dtype(dtype)
    jw = jq.dequantize().astype(jdt)
    ref = np.asarray(jnp.dot(jnp.asarray(x).astype(jdt), jw).astype(
        jnp.float32))
    tdt = getattr(torch, dtype)
    q = torch.from_numpy(np.array(jq.q))
    scale = torch.from_numpy(np.array(jq.scale))
    np.testing.assert_array_equal(
        (q.float() * scale).to(tdt).float().numpy(),
        np.asarray(jw.astype(jnp.float32)))
    out = im.int8_matmul_plain(torch.from_numpy(x).to(tdt), q, scale)
    assert out.dtype == tdt and out.shape == (7, n)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(im.int8_matmul(torch.from_numpy(x).to(tdt), q, scale),
                       out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [(64, 32, 32), (96, 96)])
def test_int8_matmul_group_matches_jax_dequantize_then_dense(dtype, ns):
    """One grouped call (a layer's query, key and value at 2:1 GQA; a
    SwiGLU gate and input) through ``int8_matmul_group`` — K6's grouped
    launch; its plain version on the CPU — against each weight's
    ``QTensor.dequantize()`` followed by flax ``nn.Dense(dtype=...)``: f32
    within 1e-5 relative (summation order), bf16 within one bf16
    rounding (rtol 1e-2) of outputs of O(1); each output as the
    one-weight call gives it, bit for bit."""
    rng = np.random.default_rng(sum(ns))
    k = 48
    x = rng.standard_normal((5, k)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    weights, refs = [], []
    for n in ns:
        jq = jquant.quantize_tensor(jnp.asarray(
            (rng.standard_normal((k, n)) * 0.05).astype(np.float32)))
        dense = nn.Dense(n, dtype=jdt)
        refs.append(np.asarray(dense.apply(
            {"params": {"kernel": jq.dequantize(),
                        "bias": jnp.zeros((n,), jnp.float32)}},
            jnp.asarray(x)).astype(jnp.float32)))
        weights.append((torch.from_numpy(np.array(jq.q)),
                        torch.from_numpy(np.array(jq.scale))))
    xt = torch.from_numpy(x).to(tdt)
    outs = im.int8_matmul_group(xt, weights)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-2)
    for out, ref, (q, scale), n in zip(outs, refs, weights, ns):
        assert out.dtype == tdt and out.shape == (5, n)
        np.testing.assert_allclose(out.float().numpy(), ref, **tol)
        assert torch.equal(out, im.int8_matmul(xt, q, scale))


def _cu_constants(namespace):
    """The ``constexpr int`` constants of ``csrc/int8_matmul.cu``'s
    ``namespace``."""
    src = (Path(kernels.CSRC_DIR) / "int8_matmul.cu").read_text()
    start = src.index(f"namespace {namespace} {{")
    body = src[start:src.index(f"}}  // namespace {namespace}")]
    return {m.group(1): int(m.group(2)) * int(m.group(3) or 1)
            for m in re.finditer(
                r"constexpr int (k\w+) = (\d+)(?: \* (\d+))?;", body)}


def _cdiv(a, b):
    return -(-a // b)


class _FakeInt8Library:
    """Stands in for the built library: records the C entry points'
    arguments and refuses what ``csrc/int8_matmul.cu`` refuses.
    ``port_int8_matmul`` (hop::): anything but the plan its ``plan_for``
    computes from (M, K, the weights' N) with the file's constants (rows
    8, 16 or 32, the fewest holding M; K cut into at most
    ``kMaxCluster`` ranges of a multiple of 16 rows, each at least one
    64-row slot, toward ``kTargetCtas`` CTAs; x's window; 16-byte copies
    only when every N is a multiple of 16), 1-3 weights, a grid over
    65535 along y or z, and a plan whose shared memory exceeds what its
    instantiation sets once (``max_smem``)."""

    def __init__(self):
        self.calls = []
        self.c = _cu_constants("hop")

    def _plan(self, m, k, ns, size):
        c = self.c
        rows = 8 if m <= 8 else 16 if m <= 16 else 32
        tiles = sum(_cdiv(n, c["kTileN"]) for n in ns)
        want = max(1, min(c["kMaxCluster"],
                          _cdiv(c["kTargetCtas"], tiles * _cdiv(m, rows)),
                          k // c["kStageK"]))
        kps = _cdiv(_cdiv(k, want), c["kKAlign"]) * c["kKAlign"]
        cap = ((c["kXBytes"] // (rows * size) - c["kXPad"]) // c["kStageK"]
               * c["kStageK"])
        xw = min(_cdiv(kps, c["kStageK"]) * c["kStageK"], cap)
        vec = 16 if all(n % 16 == 0 for n in ns) else 1
        ring = c["kStages"] * c["kStageK"] * c["kTileN"]
        sums = (c["kThreads"] // 32 + 1) * 4 * rows * c["kTileN"]
        smem = rows * (xw + c["kXPad"]) * size + max(ring, sums)
        return rows, _cdiv(k, kps), kps, xw, vec, tiles, smem

    def max_smem(self, rows, size):
        """``hop::max_smem<T, rows>``: the plan's shared memory at x's
        widest window, which the kernel's attribute is set to once."""
        c = self.c
        cap = ((c["kXBytes"] // (rows * size) - c["kXPad"]) // c["kStageK"]
               * c["kStageK"])
        ring = c["kStages"] * c["kStageK"] * c["kTileN"]
        sums = (c["kThreads"] // 32 + 1) * 4 * rows * c["kTileN"]
        return rows * (cap + c["kXPad"]) * size + max(ring, sums)

    def port_int8_matmul(self, x, q0, q1, q2, s0, s1, s2, y0, y1, y2, n0,
                         n1, n2, groups, m, k, vec, rows, splits, kps, xw,
                         dtype, device, stream):
        ns = (n0, n1, n2)[:groups]
        self.calls.append((m, k, ns, vec, rows, splits, kps, xw))
        if not 1 <= groups <= 3 or min(ns) < 1 or dtype not in (0, 1):
            return 1
        size = 4 if dtype == 0 else 2
        want_rows, want_splits, want_kps, want_xw, want_vec, tiles, smem = \
            self._plan(m, k, ns, size)
        ok = ((rows, splits, kps, xw, vec) == (want_rows, want_splits,
                                               want_kps, want_xw, want_vec)
              and tiles <= 65535 and _cdiv(m, rows) <= 65535
              and smem <= self.max_smem(rows, size))
        return 0 if ok else 1


def _fake_int8(monkeypatch):
    fake = _FakeInt8Library()
    monkeypatch.setattr(kernels, "library", lambda: fake)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(kernels, "launch_args", lambda device: (0, None))
    return fake


INT8_SWEEP_ROWS = (1, 2, 3, 5, 8, 9, 40, 100)
INT8_SWEEP_SHAPES = ((768, 768), (768, 3072), (3072, 768), (768, 32000),
                     (64, 259), (33, 7), (1, 129), (5000, 16), (100, 130))


def test_int8_plan_fits_the_kernel_at_every_shape(monkeypatch):
    """``int8_plan`` is a function of the shape alone, keeps the kernel's
    constants, and every plan launches through the wrapper as the kernel
    checks it — GPT-small's weights, the cb --spec pair's vocab 259, and
    tails of N and K that are not multiples of 16, 64 or 128, in bf16
    and f32. A plan's K ranges tile K in multiples of 16 in at most 8
    (one cluster), each but a one-range plan at least 64 rows; x's
    window is a whole number of 64-row slots within 48 KB; a CTA's
    shared memory is at most what the kernel sets once for its
    instantiation (``max_smem``), which fits the card. At decode (M <= 8) on GPT-small's
    768-deep weights the grid has at least 72 CTAs."""
    consts = _cu_constants("hop")
    assert (consts["kTileN"], consts["kStageK"], consts["kStages"],
            consts["kKAlign"], consts["kMaxCluster"], consts["kTargetCtas"],
            consts["kXBytes"], consts["kXPad"], consts["kMaxGroups"]) == (
        im.TILE_N, im.STAGE_K, im.STAGES, im.K_ALIGN, im.MAX_CLUSTER,
        im.TARGET_CTAS, im.X_BYTES, im.X_PAD, im.MAX_GROUPS)
    assert consts["kThreads"] // 32 == im.PARTS
    fake = _fake_int8(monkeypatch)
    before = im.launches
    calls = 0
    for m in INT8_SWEEP_ROWS:
        for k, n in INT8_SWEEP_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                plan = im.int8_plan(m, k, n, dtype)
                assert plan == im.int8_plan(m, k, (n,), dtype)
                assert plan.rows == next(r for r in (8, 16, 32)
                                         if r >= min(m, 32))
                assert 1 <= plan.splits <= im.MAX_CLUSTER
                assert plan.k_per_split % im.K_ALIGN == 0
                assert ((plan.splits - 1) * plan.k_per_split < k
                        <= plan.splits * plan.k_per_split)
                assert plan.splits == 1 or plan.k_per_split >= im.STAGE_K
                assert plan.x_window % im.STAGE_K == 0
                assert (plan.rows * (plan.x_window + im.X_PAD)
                        * dtype.itemsize <= im.X_BYTES)
                size = dtype.itemsize
                assert plan.smem == fake._plan(m, k, (n,), size)[-1]
                assert plan.smem <= fake.max_smem(plan.rows, size) <= 232448
                x = torch.zeros(m, k, dtype=dtype, device="meta")
                q = torch.zeros(k, n, dtype=torch.int8, device="meta")
                scale = torch.zeros(n, device="meta")
                y = im.int8_matmul(x, q, scale)
                calls += 1
                assert y.shape == (m, n) and y.dtype == dtype
                assert fake.calls[-1] == (m, k, (n,), plan.vec, plan.rows,
                                          plan.splits, plan.k_per_split,
                                          plan.x_window)
                ctas = _cdiv(n, im.TILE_N) * plan.splits * _cdiv(m, plan.rows)
                if m <= 8 and k == 768:
                    assert ctas >= 72
    assert im.launches == before + calls
    # the kernel's attribute, set once an instantiation, is the widest
    # window's plan: no lower than a plan can ask
    for dtype in (torch.bfloat16, torch.float32):
        plan = im.int8_plan(8, 64 * 8 * 1024, 64, dtype)
        assert plan.smem == fake.max_smem(8, dtype.itemsize)
    with pytest.raises(TypeError):
        im.int8_plan(8, 768, 768, torch.float16)
    with pytest.raises(ValueError):
        im.int8_plan(0, 768, 768, torch.float32)
    with pytest.raises(ValueError):
        im.int8_plan(8, 768, (768,) * 4, torch.float32)


def test_int8_group_is_one_launch(monkeypatch):
    """A grouped call (GPT-small's query, key and value; a GQA cut whose
    key and value are narrower; a SwiGLU gate and input) is one launch
    of ``port_int8_matmul`` with every weight's N, counted once, its
    plan tiling the weights' columns together; a weight whose N is not a
    multiple of 16 takes byte loads for the group."""
    fake = _fake_int8(monkeypatch)
    for m, k, ns in ((8, 768, (768, 768, 768)), (8, 1024, (1024, 256, 256)),
                     (40, 768, (3072, 3072)), (3, 64, (64, 259))):
        for dtype in (torch.bfloat16, torch.float32):
            before = im.launches
            x = torch.zeros(m, k, dtype=dtype, device="meta")
            weights = [(torch.zeros(k, n, dtype=torch.int8, device="meta"),
                        torch.zeros(n, device="meta")) for n in ns]
            ys = im.int8_matmul_group(x, weights)
            assert im.launches == before + 1
            assert [tuple(y.shape) for y in ys] == [(m, n) for n in ns]
            plan = im.int8_plan(m, k, ns, dtype)
            assert fake.calls[-1] == (m, k, ns, plan.vec, plan.rows,
                                      plan.splits, plan.k_per_split,
                                      plan.x_window)
            assert plan.vec == (16 if all(n % 16 == 0 for n in ns) else 1)
    # GPT-small's decode step: the q/k/v group fills the card without
    # more splits than one 768-wide weight needs
    assert im.int8_plan(8, 768, (768,) * 3, torch.bfloat16).splits <= \
        im.int8_plan(8, 768, 768, torch.bfloat16).splits


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
def test_k6_launches_per_step_counts_the_dense_groups(ffn, monkeypatch):
    """``CausalLM.k6_launches_per_step`` is what an in-loop forward
    launches: one for each layer's query/key/value, one for SwiGLU's gate
    and input, one for each other int8 Dense, one for lm_head (2 layers:
    9 either way, from 13 and 15 int8 Dense); a float model launches
    none, and a forward outside the loop dequantizes instead."""
    from pyspark_tf_gke_tpu_torch.models import layers

    _, _, tmodel = _int8_pair(ffn=ffn)
    launched = []
    single, group = layers.int8_matmul, layers.int8_matmul_group
    monkeypatch.setattr(layers, "int8_matmul", lambda *a: (
        launched.append(1), single(*a))[1])
    monkeypatch.setattr(layers, "int8_matmul_group", lambda x, w: (
        launched.append(len(w)), group(x, w))[1])
    ids = torch.ones(2, 1, dtype=torch.long)
    cache = tlm.DenseCache(tmodel.cfg, 2, tmodel.cfg.max_seq_len, "cpu")
    with torch.inference_mode():
        tmodel(ids, positions=torch.zeros(2, 1, dtype=torch.long),
               cache=cache, inloop=True)
    assert len(launched) == tmodel.k6_launches_per_step() == 9
    assert sum(launched) == TINY["num_layers"] * (
        7 if ffn == "swiglu" else 6) + 1
    launched.clear()
    with torch.inference_mode():
        tmodel(ids, positions=torch.ones(2, 1, dtype=torch.long),
               cache=cache)
    assert not launched
    float_model = tlm.CausalLM(tmodel.cfg)
    assert float_model.k6_launches_per_step() == 0


# -- weights resident ---------------------------------------------------------


def test_int8_model_holds_int8_and_no_float_copy(dense, tmp_path):
    """Every quantized path of the tree is an int8 parameter with its f32
    scales in the port model (per column on a Dense kernel, per row on a
    table), equal to the JAX tree's; the model's bytes are exactly the
    tree's ``tree_bytes`` (the JAX package's count of the same tree), so
    no float copy of a quantized path exists. The same holds for a model
    loaded from an int8 bundle."""
    _, qparams, tmodel = dense
    params = params_from_flax(qparams)
    qpaths = sorted(p for p, leaf in params.items()
                    if isinstance(leaf, QTensor))
    assert len(qpaths) == 2 + 6 * TINY["num_layers"] + 1  # wte, wpe, head

    def held(model):
        own = model.flax_parameters()
        for path in qpaths:
            module = model.get_submodule(path.rsplit("/", 1)[0].replace(
                "/", "."))
            scale = (module.embedding_scale if path.endswith("embedding")
                     else module.kernel_scale)
            assert own[path].dtype == torch.int8, path
            assert torch.equal(own[path], params[path].q)
            assert torch.equal(scale.reshape(params[path].scale.shape),
                               params[path].scale)
        return sum(t.numel() * t.element_size()
                   for t in list(model.parameters()) + list(model.buffers()))

    assert held(tmodel) == tree_bytes(params) == jquant.tree_bytes(qparams)
    cfg = tmodel.cfg
    bundle = texport.export_serving_bundle(cfg, params, str(tmp_path / "b"))
    loaded, _, meta = texport.load_serving_bundle(bundle, "cpu")
    assert meta["quantized_paths"] == qpaths
    assert held(loaded) == tree_bytes(params)
    # a trainable model takes the same tree as float weights
    trainable = tlm.CausalLM(cfg, param_dtype=torch.float32)
    trainable.load_params(params)
    assert all(p.dtype == torch.float32 for p in trainable.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_row_gather_equals_dequantize_then_gather(dense, dtype):
    """``gather_rows`` of int8 rows equals the JAX decode's hoisted
    ``dequantize_embeddings`` table gathered and cast, bit for bit."""
    _, qparams, tmodel = dense
    ids = np.random.default_rng(4).integers(0, 97, (3, 11))
    table = jquant.dequantize_embeddings(qparams)["wte"]["embedding"]
    ref = np.asarray(jnp.take(table, jnp.asarray(ids), axis=0).astype(
        jnp.dtype(dtype)).astype(jnp.float32))
    qt = qparams["wte"]["embedding"]
    got = gather_rows(torch.from_numpy(np.array(qt.q)),
                      torch.from_numpy(np.array(qt.scale)),
                      torch.from_numpy(ids), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(
        tmodel.wte(torch.from_numpy(ids)).numpy(),
        np.asarray(jnp.take(table, jnp.asarray(ids), axis=0)))


# -- the decode paths against the JAX package ---------------------------------


def test_inloop_decode_logits_and_generate_match_jax(dense):
    """A prefill and one in-loop decode step (the JAX ``_decode`` body:
    ``inloop_dequantize`` weights, hoisted embeddings) give the port's
    logits within 1e-4; greedy ``generate`` is token-exact."""
    jmodel, qparams, tmodel = dense
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 97, (2, 9)).astype(np.int32)
    b, s = prompt.shape
    logits, mut = jmodel.apply({"params": jquant.dequantize_tree(qparams)},
                               jnp.asarray(prompt), prefill=True,
                               mutable=["cache"])
    tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1)).astype(np.int32)
    step_params = jquant.inloop_dequantize(
        jquant.dequantize_embeddings(qparams))
    jstep, _ = jmodel.apply({"params": step_params, "cache": mut["cache"]},
                            jnp.asarray(tok)[:, None], decode=True,
                            positions=jnp.full((b, 1), s, jnp.int32),
                            mutable=["cache"])
    cache = tlm.DenseCache(tmodel.cfg, b, tmodel.cfg.max_seq_len, "cpu")
    with torch.inference_mode():
        tpre = tmodel(torch.from_numpy(prompt).long(), cache=cache,
                      prefill=True)
        tstep = tmodel(torch.from_numpy(tok).long()[:, None],
                       positions=torch.full((b, 1), s), cache=cache,
                       inloop=True)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(logits),
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                               atol=DECODE_ATOL)
    ref = jgenerate(jmodel, qparams, jnp.asarray(prompt), max_new_tokens=12)
    out = tlm.generate(tmodel, prompt, max_new_tokens=12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_on_int8_weights_matches_jax(dense, layout):
    if layout == "paged":
        jmodel, qparams, tmodel = _int8_pair(kv_page_size=16,
                                             kv_num_pages=24)
    else:
        jmodel, qparams, tmodel = dense
    rng = np.random.default_rng(6)
    specs = [(rng.integers(1, 97, n), m)
             for n, m in [(5, 12), (19, 3), (33, 8), (7, 10)]]
    kw = dict(num_slots=2, chunk=3, buckets=(16, 32, 64))

    def run(engine):
        rids = [engine.submit(p, max_new_tokens=m) for p, m in specs]
        out = dict(engine.run_until_drained())
        return [out[r] for r in rids]

    assert run(ContinuousEngine(tmodel, **kw)) == run(
        JaxEngine(jmodel, qparams, **kw))


def test_beam_search_on_int8_weights_matches_jax(dense):
    jmodel, qparams, tmodel = dense
    prompt = np.random.default_rng(7).integers(1, 97, (2, 6)).astype(
        np.int32)
    seqs, scores = jbeam(jmodel, qparams, jnp.asarray(prompt), 8,
                         num_beams=3, eos_token_id=5)
    tseqs, tscores = beam_search(tmodel, prompt, 8, num_beams=3,
                                 eos_token_id=5)
    np.testing.assert_array_equal(tseqs.numpy(), np.asarray(seqs))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(scores), rtol=0,
                               atol=1e-5)
