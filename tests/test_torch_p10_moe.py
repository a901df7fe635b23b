"""PyTorch port, the MoE FFN (``models/moe.py``) and MoE-BERT against
the JAX package on the CPU.

* ``route()`` against the JAX layer's own routing body fed the SAME
  gates (the JAX module's ``softmax`` answers with them and its einsums
  are recorded): dispatch and combine exactly, at k = 1 and 2, with and
  without capacity drops; the aux loss within 1e-6 relative (a mean
  summed in another order).
* ``MoELayer`` forward, aux and every gradient (the router's included)
  against the JAX layer on its own parameters: f32 within 1e-5 relative
  to each tensor's scale, bf16 within 2e-2 of the output's scale.
  Routing is discontinuous, so the inputs are checked to have every
  token's top-k gates apart by more than 1e-4: an f32 rounding
  difference between XLA and PyTorch cannot flip a pick there.
* One expert equals the dense FFN; at k = 1 the router takes a
  main-path gradient and the output is ``gate * FFN``.
* MoE-BERT (``num_experts=4``, top 2, every layer) against JAX
  ``BertForPretraining``: logits, aux and the step-0 gradients (f32,
  the tolerances of ``test_torch_bert.py``), and ``bert_finetune
  --num-experts 2 --moe-every 1`` against the JAX CLI from the same
  initial parameters on the same shards, read in the same order (the
  history's keys, and each epoch's loss within 1e-4).
* MoE under an sp group of more than one rank raises, naming P11c.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import pyspark_tf_gke_tpu.models.moe as jmoe
from pyspark_tf_gke_tpu.data import native_tfrecord as jtf
from pyspark_tf_gke_tpu.models.bert import BertConfig as JaxBertConfig
from pyspark_tf_gke_tpu.models.bert import BertForPretraining as JaxBert
from pyspark_tf_gke_tpu.train import bert_finetune as jbert_finetune
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu_torch.data.tfrecord import write_tfrecord_shards
from pyspark_tf_gke_tpu_torch.models import bert as tb
from pyspark_tf_gke_tpu_torch.models.layers import load_flax_params
from pyspark_tf_gke_tpu_torch.models.moe import MoELayer, capacity, route
from pyspark_tf_gke_tpu_torch.train import bert_finetune
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

MARGIN = 1e-4
SEQ, VOCAB = 16, 96
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=64,
           num_experts=4, moe_top_k=2, moe_every=1)


class _Proxy:
    """A module stand-in: ``over``'s names, else the module's."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(
            self._base, name)


def _jax_route(monkeypatch, gates, k, capacity_factor):
    """The JAX layer's routing body on ``gates``: its ``softmax`` returns
    them; dispatch and combine are the first operands of its first and
    last einsums (f32, so their casts are exact)."""
    calls = []

    def einsum(spec, a, b):
        calls.append((spec, np.asarray(a)))
        return jnp.einsum(spec, a, b)

    fake_nn = _Proxy(jax.nn, softmax=lambda *a, **kw: jnp.asarray(gates))
    monkeypatch.setattr(jmoe, "jax", _Proxy(jax, nn=fake_nn))
    monkeypatch.setattr(jmoe, "jnp", _Proxy(jnp, einsum=einsum))
    b, s, e = gates.shape
    layer = jmoe.MoELayer(num_experts=e, hidden_size=8, intermediate_size=8,
                          top_k=k, capacity_factor=capacity_factor,
                          dtype=jnp.float32)
    x = jnp.ones((b, s, 8), jnp.float32)
    variables = layer.init(jax.random.key(0), x)
    calls.clear()
    _, aux = layer.apply(variables, x)
    monkeypatch.undo()
    assert calls[0][0] == "bsec,bsh->ebch" and calls[-1][0] == "bsec,ebch->bsh"
    return calls[0][1], calls[-1][1], float(aux)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity_factor", [0.5, 8.0],
                         ids=["drops", "no_drops"])
def test_route_equals_the_jax_routing_body(monkeypatch, k, capacity_factor):
    rng = np.random.default_rng(k)
    b, s, e = 3, 12, 4
    logits = rng.normal(0, 2, (b, s, e)).astype(np.float32)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want_d, want_c, want_aux = _jax_route(monkeypatch, gates, k,
                                          capacity_factor)
    cap = capacity(capacity_factor, k, s, e)
    assert want_d.shape == (b, s, e, cap)
    dispatch, combine, aux, top1 = route(torch.from_numpy(gates), k, cap)
    np.testing.assert_array_equal(dispatch.numpy(), want_d)
    np.testing.assert_array_equal(combine.numpy(), want_c)
    assert float(aux) == pytest.approx(want_aux, rel=1e-6)
    assert torch.equal(top1.argmax(-1), torch.from_numpy(gates).argmax(-1))
    kept = dispatch.sum(dim=(2, 3))
    if capacity_factor < 1:
        assert float(kept.sum()) < b * s * k  # some tokens dropped
    else:
        assert torch.equal(kept, torch.full((b, s), float(k)))


def _margins(gates: np.ndarray, k: int) -> float:
    """The least gap between a token's consecutive top-(k+1) gates."""
    top = -np.sort(-gates, axis=-1)[..., :k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


def _tensors(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,capacity_factor", [(1, 4.0), (2, 1.25),
                                               (2, 0.5)])
def test_moe_layer_matches_jax(dtype, k, capacity_factor):
    b, s, h, inter, e = 2, 16, 16, 32, 4
    rng = np.random.default_rng(10 + k)
    x = rng.normal(0, 1, (b, s, h)).astype(np.float32)
    jlayer = jmoe.MoELayer(num_experts=e, hidden_size=h,
                           intermediate_size=inter, top_k=k,
                           capacity_factor=capacity_factor,
                           dtype=getattr(jnp, dtype))
    params = jax.device_get(nn.meta.unbox(jlayer.init(
        jax.random.key(3), jnp.asarray(x))["params"]))
    # a router wide enough that no two of a token's top-k+1 gates lie
    # within MARGIN of each other (asserted below)
    params["router"] = params["router"] * 40.0
    gates = np.asarray(jax.nn.softmax(x @ params["router"], axis=-1))
    assert _margins(gates, k) > MARGIN

    def jloss(p, xx):
        out, aux = jlayer.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params, jnp.asarray(x))
    layer = MoELayer(e, h, inter, k, capacity_factor,
                     getattr(torch, dtype), device="cpu")
    load_flax_params(layer, _tensors(params))
    out, aux = layer(torch.from_numpy(x))
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    (out.float().pow(2).sum() + aux).backward()
    jout = np.asarray(jout, np.float32)
    scale = np.abs(jout).max()
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), jout,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(out.detach().numpy(), jout,
                                   atol=2e-2 * scale)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    if dtype != "float32":
        return
    for name, p in layer.named_parameters():
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    assert float(layer.router.grad.norm()) > 0


def test_single_expert_equals_dense():
    torch.manual_seed(0)
    layer = MoELayer(1, 16, 32, top_k=1, capacity_factor=2.0,
                     dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, 0.3)
    x = torch.randn(2, 8, 16)
    out, aux = layer(x)
    dense = torch.nn.functional.gelu(x @ layer.w_in[0] + layer.b_in[0],
                                     approximate="tanh")
    dense = dense @ layer.w_out[0] + layer.b_out[0]
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(1.0, abs=1e-6)


def test_top1_router_gets_main_path_gradient():
    """k = 1 keeps the raw gate as the combine weight: the router is on
    the differentiable path of the output alone (no aux loss), and the
    output is ``gate * FFN`` of the picked expert."""
    torch.manual_seed(1)
    e = 4
    layer = MoELayer(e, 8, 16, top_k=1, capacity_factor=4.0,
                     dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0, 0.5)
    x = torch.randn(2, 8, 8)
    out, _ = layer(x)
    out.pow(2).sum().backward()
    assert float(layer.router.grad.norm()) > 1e-6
    with torch.no_grad():
        gates = torch.softmax(x @ layer.router, -1)
        pick = gates.argmax(-1)
        assert float(gates.max()) < 1.0
        for bi in range(2):
            for si in range(8):
                ei = int(pick[bi, si])
                ffn = torch.nn.functional.gelu(
                    x[bi, si] @ layer.w_in[ei] + layer.b_in[ei],
                    approximate="tanh") @ layer.w_out[ei] + layer.b_out[ei]
                torch.testing.assert_close(out[bi, si],
                                           gates[bi, si, ei] * ffn,
                                           rtol=1e-5, atol=1e-6)


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32)
    mask = np.ones((b, SEQ), np.int32)
    mask[1, 9:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _gate_margins(model, batch, k):
    """Each MoE layer's least top-(k+1) gate gap on ``batch``."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(
        torch.softmax(args[0].float() @ mod.router, -1).detach().numpy()))
        for m in model.modules() if isinstance(m, MoELayer)]
    with torch.no_grad():
        model(torch.from_numpy(batch["input_ids"]),
              attention_mask=torch.from_numpy(batch["attention_mask"]))
    for h in hooks:
        h.remove()
    return [_margins(g, k) for g in seen]


def test_moe_bert_matches_jax():
    batch = _batch()
    jcfg = JaxBertConfig(**CFG, dtype=jnp.float32)
    jmodel = JaxBert(jcfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(3), jnp.asarray(batch["input_ids"]),
        attention_mask=jnp.asarray(batch["attention_mask"]))["params"]))
    for i in range(CFG["num_layers"]):  # gates apart by MARGIN, asserted
        moe = params["encoder"][f"layer_{i}"]["moe"]
        moe["router"] = moe["router"] * 8.0
    jtask = jtrainer.TASKS["bert_classification"]()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        preds, _ = jtask.forward(jmodel, {"params": p}, jbatch, True, False)
        return jtask.loss_and_metrics(preds, jbatch)[0], preds

    (jl, jpreds), jgrads = jax.jit(jax.value_and_grad(jax_loss,
                                                     has_aux=True))(params)
    jgrads = _flat(jax.device_get(jgrads))

    model = tb.BertForPretraining(tb.BertConfig(**CFG, dtype=torch.float32),
                                  param_dtype=torch.float32)
    model.load_params(tb.bert_params_from_flax(params))
    paths = set(model.flax_parameters())
    assert paths == set(_flat(params))
    assert "encoder/layer_0/moe/w_in" in paths
    assert not any("mlp_in" in p for p in paths)
    assert min(_gate_margins(model, batch, CFG["moe_top_k"])) > MARGIN
    ttask = ttrainer.TASKS["bert_classification"]()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    preds = ttask.forward(model, tbatch)
    loss, metrics = ttask.loss_and_metrics(preds, tbatch)
    loss.backward()
    for key in ("mlm_logits", "cls_logits"):
        np.testing.assert_allclose(preds[key].detach().numpy(),
                                   np.asarray(jpreds[key]), atol=1e-5,
                                   err_msg=key)
    assert float(preds["aux_loss"]) == pytest.approx(
        float(jpreds["aux_loss"]), rel=1e-6)
    assert float(preds["aux_loss"]) > 0
    assert float(metrics["moe_aux_loss"]) == float(preds["aux_loss"])
    assert float(loss) == pytest.approx(float(jl), abs=1e-5)
    for path, p in model.flax_parameters().items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[path]),
                                   atol=1e-4, rtol=1e-4, err_msg=path)
    assert float(model.encoder.layer_0.moe.router.grad.norm()) > 0


def test_moe_bert_remat_and_dense_aux():
    """remat's checkpoint carries each layer's (hidden, aux); a dense
    config's aux is 0."""
    batch = _batch(seed=3)
    ids = torch.from_numpy(batch["input_ids"])
    cfg = tb.BertConfig(**CFG, dtype=torch.float32)
    params = tb.init_params(cfg, seed=5)
    outs = []
    for remat in (False, True):
        import dataclasses

        model = tb.BertForPretraining(dataclasses.replace(cfg, remat=remat),
                                      param_dtype=torch.float32)
        model.load_params(params)
        preds = model(ids)
        (preds["cls_logits"].sum() + preds["aux_loss"]).backward()
        outs.append((preds["aux_loss"].detach(),
                     model.encoder.layer_1.moe.router.grad.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1])
    dense = tb.BertForPretraining(tb.BertConfig(
        **{**CFG, "num_experts": 0}, dtype=torch.float32))
    assert float(dense(ids)["aux_loss"]) == 0.0
    # every moe_every-th layer holds the experts
    every2 = tb.BertForPretraining(tb.BertConfig(
        **{**CFG, "moe_every": 2}, dtype=torch.float32))
    assert not hasattr(every2.encoder.layer_0, "moe")
    assert hasattr(every2.encoder.layer_1, "moe")


def test_moe_under_sp_raises(monkeypatch):
    monkeypatch.setattr(tb, "sp_world", lambda group: 2)
    with pytest.raises(NotImplementedError, match="P11c"):
        tb.BertForPretraining(tb.BertConfig(**CFG, dtype=torch.float32),
                              sp_group=object())
    # the dense encoder still builds under sp
    tb.BertForPretraining(tb.BertConfig(**{**CFG, "num_experts": 0},
                                        dtype=torch.float32),
                          sp_group=object())


@pytest.fixture
def _clean_env(monkeypatch):
    for var in ("DATA_PATTERN", "NUM_PROCESSES", "MESH_SHAPE", "OUTPUT_DIR",
                "EPOCHS", "BATCH_SIZE", "MAX_RESTARTS", "OBJECTIVE",
                "DEVICE", "NUM_EXPERTS", "MOE_EVERY", "DCN_MESH_SHAPE"):
        monkeypatch.delenv(var, raising=False)


def test_bert_finetune_num_experts_matches_the_jax_cli(tmp_path, monkeypatch,
                                                       _clean_env):
    rng = np.random.default_rng(0)
    n = 96
    ids = rng.integers(1, VOCAB, (n, SEQ)).astype(np.int64)
    lengths = rng.integers(6, SEQ + 1, n)
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int64)
    labels = (ids[:, 0] >= VOCAB // 2).astype(np.int64)
    prefix = str(tmp_path / "shards" / "train")
    write_tfrecord_shards({"input_ids": ids * mask, "attention_mask": mask,
                           "label": labels}, prefix, num_shards=2)
    common = ["--data-pattern", f"{prefix}-*.tfrecord", "--seq-len",
              str(SEQ), "--vocab-size", str(VOCAB), "--hidden-size", "32",
              "--num-layers", "2", "--num-heads", "4", "--intermediate-size",
              "64", "--compute-dtype", "float32", "--epochs", "2",
              "--steps-per-epoch", "3", "--batch-size", "16",
              "--learning-rate", "1e-3", "--num-experts", "2",
              "--moe-every", "1", "--seed", "7",
              "--heartbeat-every-steps", "0"]
    # the JAX CLI reads through the native pool, which interleaves its
    # threads' rows unless it has one (test_torch_tfrecord.py reads it so)
    monkeypatch.setattr(jbert_finetune, "read_tfrecord_batches",
                        functools.partial(jtf.read_tfrecord_batches,
                                          nthreads=1))
    want = jbert_finetune.main(common + ["--output-dir",
                                         str(tmp_path / "jax")])
    # the port starts from the JAX CLI's own initial parameters
    jcfg = JaxBertConfig(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64,
                         max_position_embeddings=512, dtype=jnp.float32,
                         num_experts=2, moe_every=1)
    jparams = jax.device_get(nn.meta.unbox(JaxBert(jcfg).init(
        jax.random.key(7), jnp.zeros((1, SEQ), jnp.int32),
        attention_mask=jnp.ones((1, SEQ), jnp.int32))["params"]))
    monkeypatch.setattr(bert_finetune, "init_params",
                        lambda cfg, num_labels, seed:
                        tb.bert_params_from_flax(jparams))
    got = bert_finetune.main(common + ["--output-dir", str(tmp_path / "port"),
                                       "--device", "cpu"])
    assert set(got) == set(want)
    assert "moe_aux_loss" in got
    for key in ("loss", "accuracy", "moe_aux_loss"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)
