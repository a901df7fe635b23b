"""PyTorch port, model: JAX-initialised parameters carried over with
``params_from_flax`` give the same logits, the same greedy tokens and
the same per-step paged slot-decode logits as the JAX ``CausalLM``.

Tolerance: 1e-4 absolute on f32 logits (two layers of f32 matmuls whose
sums run in another order on each side; logits are O(0.1-1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.ops.quant import dequantize_tree, quantize_tree
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   params_from_flax)

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4


def _jax_model(kind, vocab=97, **extra):
    base = dict(vocab_size=vocab, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_seq_len=128, dtype=jnp.float32,
                **extra)
    cfg = (jlm.llama_like(num_kv_heads=2, **base) if kind == "llama"
           else jlm.CausalLMConfig(**base))
    model = jlm.CausalLM(cfg)
    params = nn.meta.unbox(model.init(jax.random.key(0),
                                      jnp.ones((1, 8), jnp.int32))["params"])
    return model, jax.device_get(params)


def port_model(jmodel, params, **cfg_overrides):
    fields = dataclasses.asdict(jmodel.cfg)
    fields["dtype"] = jnp.dtype(jmodel.cfg.dtype).name
    fields.update(cfg_overrides)
    model = tlm.CausalLM(config_from_dict(fields))
    return model.load_params(params_from_flax(params)).eval()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_full_forward_logits_match_jax(kind, quant):
    jmodel, params = _jax_model(kind)
    if quant:
        params = jax.device_get(quantize_tree(params, min_size=512))
    ids = np.random.default_rng(0).integers(0, 97, (2, 24)).astype(np.int32)
    ref = jmodel.apply({"params": dequantize_tree(params)}, jnp.asarray(ids),
                       train=False)
    model = port_model(jmodel, params)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_greedy_generate_token_exact(kind):
    jmodel, params = _jax_model(kind)
    prompt = np.random.default_rng(1).integers(1, 97, (2, 9)).astype(np.int32)
    ref = jlm.generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=12)
    out = tlm.generate(port_model(jmodel, params), prompt, max_new_tokens=12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# generate's logit options under greedy decoding (top_k and top_p filter
# only a sampled distribution, and are ignored there, as in JAX)
GENERATE_OPTIONS = {
    "repetition_penalty": dict(repetition_penalty=1.5),
    "repetition_penalty_eos": dict(repetition_penalty=1.5, eos=True),
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.5),
}


@pytest.mark.parametrize("option", list(GENERATE_OPTIONS))
@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_generate_options_token_exact(kind, option):
    """Whole-batch ``generate`` with each option, 16 new tokens, against
    the JAX ``generate``: the same tokens. With eos, the token the run
    without eos emits third in row 0 is the eos, so that row stops and
    pads with it."""
    jmodel, params = _jax_model(kind)
    prompt = np.random.default_rng(4).integers(1, 97, (2, 9)).astype(np.int32)
    kw = dict(GENERATE_OPTIONS[option])
    if kw.pop("eos", False):
        free = jlm.generate(jmodel, params, jnp.asarray(prompt),
                            max_new_tokens=16, **kw)
        kw["eos_token_id"] = int(np.asarray(free)[0, 9 + 2])
    ref = jlm.generate(jmodel, params, jnp.asarray(prompt),
                       max_new_tokens=16, **kw)
    out = tlm.generate(port_model(jmodel, params), prompt, max_new_tokens=16,
                       **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if "eos_token_id" in kw:
        row = out.numpy()[0, 9:]
        stop = int(np.argmax(row == kw["eos_token_id"]))
        assert stop <= 2 and np.all(row[stop:] == kw["eos_token_id"])


def test_sampled_generate_is_seeded():
    jmodel, params = _jax_model("gpt2")
    model = port_model(jmodel, params)
    prompt = np.random.default_rng(2).integers(1, 97, (2, 5))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tlm.generate(model, prompt, 10, temperature=0.9, top_p=0.95,
                            top_k=40, repetition_penalty=1.2, generator=gen)

    torch.testing.assert_close(run(7), run(7))
    assert not torch.equal(run(7), run(8))


@pytest.mark.parametrize("pos,kv_quant", [("rope", False), ("learned", True)])
def test_paged_slot_decode_logits_match_jax(pos, kv_quant):
    # identical block tables on both sides: slot 0 owns two pages, slot 1
    # is free (all sentinel), slot 2 owns a run of pages and crosses a
    # page boundary; every step writes one token per row then attends
    n_pages, ps = 24, 16
    jmodel, params = _jax_model("gpt2", pos_embedding=pos,
                                kv_cache_quant=kv_quant)
    jpaged = jlm.CausalLM(dataclasses.replace(
        jmodel.cfg, kv_page_size=ps, kv_num_pages=n_pages))
    model = port_model(jmodel, params, kv_page_size=ps, kv_num_pages=n_pages)
    b, mp = 3, jpaged.cfg.max_pages_per_slot
    table = np.full((b, mp), n_pages, np.int32)
    table[0, :2] = [5, 9]
    table[2, :4] = [1, 2, 3, 23]
    pos0 = np.asarray([0, 0, 10], np.int32)

    zeros = jnp.zeros((b, 1), jnp.int32)
    _, mut = jpaged.apply({"params": params}, zeros, decode=True,
                          slot_decode=True, positions=zeros,
                          mutable=["cache"])
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (jnp.asarray(table)
                            if path[-1].key == "block_table" else leaf),
        mut["cache"])
    kv = tlm.PagedKV(model.cfg, b, "cpu")
    kv.block_table.copy_(torch.from_numpy(table))

    rng = np.random.default_rng(3)
    for step in range(12):
        tok = rng.integers(0, 97, (b, 1)).astype(np.int32)
        positions = (pos0 + step)[:, None]
        ref, mut = jpaged.apply(
            {"params": params, "cache": jcache}, jnp.asarray(tok),
            decode=True, slot_decode=True, positions=jnp.asarray(positions),
            mutable=["cache"])
        jcache = mut["cache"]
        with torch.inference_mode():
            out = model(torch.from_numpy(tok).long(),
                        positions=torch.from_numpy(positions).long(),
                        cache=kv)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
