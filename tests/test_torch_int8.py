"""PyTorch port, int8 weights kept resident: K6's plain version against
the JAX package's ``QTensor.dequantize()`` followed by the product (bf16
and f32); ``int8_plan`` through a recording library that refuses what
``csrc/int8_matmul.cu`` refuses, tails included; a model loaded from an
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


def _cu_constants():
    src = (Path(kernels.CSRC_DIR) / "int8_matmul.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kTileN", "kMaxRows", "kSmemFloats", "kTargetCtas",
                         "kColsThread", "kThreads")}


class _FakeInt8Library:
    """Stands in for the built library: records ``port_int8_matmul``'s
    arguments and refuses what the C entry point refuses (a plan that is
    not the fewest rows holding M, K ranges that do not tile K in
    multiples of 32, shared memory over 48 KB, a grid over 65535 along y
    or z, 16-byte loads off N % 16, no partials for several splits)."""

    def __init__(self):
        self.calls = []

    def port_int8_matmul(self, x, q, scale, y, part, m, k, n, vec, rows,
                         splits, kps, dtype, device, stream):
        self.calls.append((m, k, n, vec, rows, splits, kps))
        fewest = rows in (1, 2, 4, 8) and rows >= min(m, 8) and (
            rows == 1 or rows // 2 < m)
        ok = (fewest and kps % 32 == 0 and (splits - 1) * kps < k
              <= splits * kps
              and rows * max(kps, 8 * 128) * 4 <= 49152
              and splits <= 65535 and -(-m // rows) <= 65535
              and vec == (16 if n % 16 == 0 else 1)
              and (splits == 1 or part is not None) and dtype in (0, 1))
        return 0 if ok else 1


def test_int8_plan_fits_the_kernel_at_every_shape(monkeypatch):
    """``int8_plan`` is a function of the shape alone, keeps the kernel's
    constants, and every plan launches through the wrapper as the kernel
    checks it — GPT-small's weights, the cb --spec pair's vocab 259, and
    tails of N and K that are not multiples of 16, 32 or 128. At decode
    (M <= 8) on GPT-small's 768-deep weights K is split until the grid
    has at least 72 CTAs, or into its 32-row steps."""
    consts = _cu_constants()
    assert (consts["kTileN"], consts["kMaxRows"], consts["kSmemFloats"],
            consts["kTargetCtas"], consts["kColsThread"]) == (
        im.TILE_N, im.MAX_ROWS, im.SMEM_FLOATS, im.TARGET_CTAS, im.VEC)
    assert consts["kThreads"] // 32 * 4 == im.K_STEP
    fake = _FakeInt8Library()
    monkeypatch.setattr(kernels, "library", lambda: fake)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(kernels, "launch_args", lambda device: (0, None))
    before = im.launches
    calls = 0
    for m in (1, 2, 3, 5, 8, 9, 40, 100):
        for k, n in ((768, 768), (768, 3072), (3072, 768), (768, 32000),
                     (64, 259), (33, 7), (1, 129), (5000, 16), (100, 130)):
            plan = im.int8_plan(m, k, n, torch.bfloat16)
            assert plan == im.int8_plan(m, k, n, torch.float32)
            x = torch.zeros(m, k, dtype=torch.bfloat16, device="meta")
            q = torch.zeros(k, n, dtype=torch.int8, device="meta")
            scale = torch.zeros(n, device="meta")
            y = im.int8_matmul(x, q, scale)
            calls += 1
            assert y.shape == (m, n) and y.dtype == torch.bfloat16
            assert fake.calls[-1] == (m, k, n) + tuple(plan)
            ctas = (-(-n // im.TILE_N)) * plan.splits * (-(-m // plan.rows))
            if m <= 8 and k == 768:
                assert 72 <= ctas or plan.splits == -(-k // 32)
    assert im.launches == before + calls
    with pytest.raises(TypeError):
        im.int8_plan(8, 768, 768, torch.float16)
    with pytest.raises(ValueError):
        im.int8_plan(0, 768, 768, torch.float32)


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
