"""PyTorch port, the sequence-parallel slice on the CPU against the JAX
package: ``flash_attention_block`` (plain, and the autograd entry that
runs the kernels on the card) against the JAX block entry in interpret
mode, with an lse cotangent and fully masked rows; the lse merge;
``ring_attention`` (dense causal and non-causal engines, the flash
block engine) and ``ulysses_attention`` (dense, causal, flash) on sp
groups of 2 and 4 gloo processes against the JAX ops on an sp mesh of
the same size (outputs, and the q/k/v gradients gathered over the
group's ranks); and ``BertForPretraining`` at sp = 2 and 4 (ring, ring
flash, Ulysses) against the JAX model on an sp mesh.

Inputs come from numpy seeds. One world of 4 is spawned for the module
(``tests/torch_sp_world.py``): sp = 4 runs on the whole world, sp = 2
on the groups ``[0, 1]`` and ``[2, 3]`` (both checked), and every rank
runs every case. Tolerances, all f32: outputs within 2e-6, gradients
within 2e-5 (the JAX and the port sum the blocks in the same ring order
but each product in another order; values are O(1), gradients O(10)),
BERT hidden states and logits within 2e-5 (two layers of products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_sp_world
from pyspark_tf_gke_tpu.ops import attention as jatt
from pyspark_tf_gke_tpu.ops.pallas.flash_attention import (
    flash_attention_block as jax_flash_block)
from pyspark_tf_gke_tpu.parallel.mesh import make_mesh
from pyspark_tf_gke_tpu_torch.ops import attention as tatt
from pyspark_tf_gke_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

OUT_ATOL, GRAD_ATOL, BERT_ATOL = 2e-6, 2e-5, 2e-5
B, H, D, S_LOCAL = 2, 4, 8, 8
BERT_CFG = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=64)


# -- the block entry ----------------------------------------------------------


def _qkv(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _block_mask(b, s):
    """A partly padded row, a fully masked batch row and a whole row."""
    mask = np.ones((b, s), bool)
    mask[0, s - 5:] = False
    mask[1] = False
    return mask


@pytest.mark.parametrize("entry", ["plain", "autograd"])
def test_flash_block_equals_the_jax_entry_with_an_lse_cotangent(entry):
    b, s, h, d = 3, 16, 2, 16
    q, k, v = _qkv(b, s, h, d, seed=11)
    mask = _block_mask(b, s)
    rng = np.random.default_rng(12)
    g_out = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g_lse = rng.standard_normal((b, s, h)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jax_flash_block(q, k, v, kv_mask=jnp.asarray(mask),
                                 interpret=True)
        return (o * g_out).sum() + (lse * g_lse).sum(), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v)
    fn = (tfa.flash_attention_block_plain if entry == "plain"
          else tfa.flash_attention_block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fn(tq, tk, tv, kv_mask=torch.from_numpy(mask))
    ((o * torch.from_numpy(g_out)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=OUT_ATOL, rtol=1e-6)
    assert (lse[1] == tfa.NEG_INF).all() and (o[1] == 0).all()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)
    assert (tq.grad[1] == 0).all() and (tk.grad[1] == 0).all()


def test_block_merge_reconstructs_full_attention():
    """The ring's arithmetic in one process: four sequence blocks, each
    query block through the block entry against each K/V block, merged
    by logsumexp (``flash_block_merge``, the ring's flash engine), equal
    attention over the whole sequence, forward and gradients (the
    padding covers the last block whole)."""
    b, s, h, d = 2, 32, 2, 16
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(b, s, h, d, seed=13))
    mask = torch.ones((b, s), dtype=torch.bool)
    mask[:, 24:] = False
    blocks = [slice(8 * j, 8 * (j + 1)) for j in range(4)]
    o = torch.cat([tatt.flash_block_merge(
        q[:, qs], ((k[:, ks], v[:, ks], mask[:, ks].contiguous())
                   for ks in blocks)) for qs in blocks], dim=1)
    ref = tatt.dot_product_attention(q, k, v, mask=mask[:, None, None, :])
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(),
                               atol=OUT_ATOL)
    g = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    g_ref = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for got, want in zip(g, g_ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL)
    assert not g[1][:, 24:].any()


def test_world_of_one_and_refusals():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 8, 4, 8, seed=14))
    mask = torch.from_numpy(_block_mask(2, 8))
    ref = tatt.dot_product_attention(q, k, v, mask=mask[:, None, None, :])
    for fn in (tatt.ring_attention, tatt.ulysses_attention):
        out = fn(q, k, v, None, kv_mask=mask)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
        assert (out[1] == 0).all()


# -- gloo worlds ----------------------------------------------------------------


def _inputs(world: int):
    s = S_LOCAL * world
    q, k, v = _qkv(B, s, H, D, seed=20 + world)
    mask = np.ones((B, s), bool)
    mask[0, s - S_LOCAL - 3:] = False  # the last block wholly padded
    mask[1, :3] = False
    return {"q": q, "k": k, "v": v, "mask": mask}


def _bert_inputs(world: int):
    """The JAX model's parameters and a padded batch of ids."""
    from pyspark_tf_gke_tpu.models.bert import BertConfig, BertForPretraining

    s = S_LOCAL * world
    rng = np.random.default_rng(30)
    ids = rng.integers(0, BERT_CFG["vocab_size"], (B, s)).astype(np.int32)
    ids_mask = np.ones((B, s), np.int32)
    ids_mask[0, s - 5:] = 0
    model = BertForPretraining(BertConfig(**BERT_CFG, dtype=jnp.float32))
    params = jax.device_get(nn.meta.unbox(model.init(
        jax.random.key(3), jnp.asarray(ids),
        attention_mask=jnp.asarray(ids_mask))["params"]))
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(val, dict):
                walk(val, path)
            else:
                flat[f"bert/p/{path}"] = np.asarray(val, np.float32)
    walk(params, "")
    return {"ids": ids, "ids_mask": ids_mask, "params": params,
            "bert/cfg": np.array(list(BERT_CFG.values())), **flat}


SP_SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One spawned world of 4 for every sp size: ``{n: (inputs, bert
    inputs, [each group's results])}``."""
    inputs = {n: _inputs(n) for n in SP_SIZES}
    bert = {n: _bert_inputs(n) for n in SP_SIZES}
    params = {n: bert[n].pop("params") for n in SP_SIZES}
    results = torch_sp_world.run_world(
        {n: {**inputs[n], **bert[n]} for n in SP_SIZES},
        str(tmp_path_factory.mktemp("sp")))
    return {n: (inputs[n], {**bert[n], "params": params[n]}, results[n])
            for n in SP_SIZES}


@pytest.fixture(params=SP_SIZES, ids=[f"sp{n}" for n in SP_SIZES])
def world(request, worlds):
    return (request.param, *worlds[request.param])


def _gathered(results, key):
    return np.concatenate(results[key], axis=1)


def _jax_case(n, inputs, op, causal, use_flash):
    """The JAX op's output and q/k/v gradients of ``sum(out ** 2)``, in
    one jitted call."""
    mesh = make_mesh({"sp": n}, jax.devices()[:n])
    fn = jatt.ring_attention if op == "ring" else jatt.ulysses_attention
    mask = jnp.asarray(inputs["mask"])

    def loss(q, k, v):
        with mesh:
            out = fn(q, k, v, mesh, kv_mask=mask, causal=causal,
                     use_flash=use_flash)
        return (out ** 2).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            inputs["q"], inputs["k"], inputs["v"])
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", torch_sp_world.ATTENTION_CASES,
                         ids=[c[0] for c in torch_sp_world.ATTENTION_CASES])
def test_sp_attention_equals_the_jax_op_on_an_sp_mesh(world, case):
    n, inputs, _, groups = world
    name, op, causal, use_flash, _ = case
    out, grads = _jax_case(n, inputs, op, causal, use_flash)
    s = inputs["q"].shape[1]
    for results in groups:
        np.testing.assert_allclose(_gathered(results, f"{name}/out"), out,
                                   atol=OUT_ATOL, err_msg=name)
        for t, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(_gathered(results, f"{name}/{t}"),
                                       want, atol=GRAD_ATOL,
                                       err_msg=f"{name} {t}")
        # the fully padded tail's keys take no gradient
        assert not _gathered(results, f"{name}/dk")[0, s - S_LOCAL:].any()


@pytest.mark.parametrize("variant", torch_sp_world.BERT_VARIANTS,
                         ids=[v[0] for v in torch_sp_world.BERT_VARIANTS])
def test_bert_sp_equals_the_jax_model_on_an_sp_mesh(world, variant):
    from pyspark_tf_gke_tpu.models.bert import (BertConfig, BertEncoder,
                                                BertForPretraining)

    n, _, bert, groups = world
    name, impl, use_flash = variant
    cfg = BertConfig(**BERT_CFG, dtype=jnp.float32, sp_impl=impl,
                     use_flash=use_flash)
    mesh = make_mesh({"sp": n}, jax.devices()[:n])
    ids, mask = jnp.asarray(bert["ids"]), jnp.asarray(bert["ids_mask"])

    @jax.jit
    def run(params, ids, mask):
        with mesh:
            preds = BertForPretraining(cfg, mesh=mesh).apply(
                {"params": params}, ids, attention_mask=mask)
            hidden, _ = BertEncoder(cfg, mesh=mesh).apply(
                {"params": params["encoder"]}, ids, attention_mask=mask)
        return preds, hidden

    preds, hidden = run(bert["params"], ids, mask)
    for results in groups:
        np.testing.assert_allclose(_gathered(results, f"{name}/hidden"),
                                   np.asarray(hidden), atol=BERT_ATOL)
        np.testing.assert_allclose(_gathered(results, f"{name}/mlm_logits"),
                                   np.asarray(preds["mlm_logits"]),
                                   atol=BERT_ATOL)
        for cls in results[f"{name}/cls_logits"]:  # every rank's copy
            np.testing.assert_allclose(cls, np.asarray(preds["cls_logits"]),
                                       atol=BERT_ATOL)
