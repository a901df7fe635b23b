"""PyTorch port, the chunked large-vocab cross-entropy
(``ops/chunked_ce.py``) against the JAX ``chunked_cross_entropy``
(``ops/chunked_ce.py:36-104``) and the trainer's ``--vocab-chunks``
loss against its dense loss.

Tolerances: loss 1e-5 relative and absolute and argmax exact (f32 sums
of the same products, in another order); gradients of hidden, kernel
and bias 1e-4 relative / 1e-5 absolute (the backward recomputes each
chunk's softmax, as ``jax.checkpoint`` of the scan body does); bf16
hidden states and kernel (JAX's f32 sums of bf16 products) the same
loss tolerance — the port sums the same exact products in f32, so no
chunk logit is rounded to bf16. A trainer step on ``vocab_chunks``
equals the dense step's loss, accuracy and sgd-updated parameters
within 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.ops.chunked_ce import chunked_cross_entropy as jax_ce
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.ops.chunked_ce import (chunk_bounds,
                                                     chunked_cross_entropy)
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

torch.set_num_threads(1)


def _inputs(seed, n, e, v, bias=True, dtype=np.float32):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(n, e)).astype(np.float32)
    kernel = (rng.normal(size=(e, v)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32) if bias else None
    labels = rng.integers(0, v, (n,)).astype(np.int32)
    return hidden, kernel, b, labels


def _port(hidden, kernel, bias, labels, chunks, dtype=torch.float32):
    h = torch.tensor(hidden, dtype=dtype, requires_grad=True)
    k = torch.tensor(kernel, dtype=dtype, requires_grad=True)
    b = None if bias is None else torch.tensor(bias, requires_grad=True)
    loss, amax = chunked_cross_entropy(h, k, b, torch.tensor(labels), chunks)
    return loss, amax, (h, k, b)


@pytest.mark.parametrize("v,chunks", [(64, 8), (97, 8), (50, 1), (32, 64)])
def test_loss_and_argmax_match_jax(v, chunks):
    hidden, kernel, bias, labels = _inputs(0, 24, 16, v)
    want_loss, want_amax = jax_ce(jnp.asarray(hidden), jnp.asarray(kernel),
                                  jnp.asarray(bias), jnp.asarray(labels),
                                  num_chunks=chunks)
    loss, amax, _ = _port(hidden, kernel, bias, labels, chunks)
    assert loss.dtype == torch.float32 and amax.dtype == torch.int32
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(want_amax))
    n_chunks = max(1, min(chunks, v))
    width = -(-v // n_chunks)
    assert chunk_bounds(v, chunks)[0] == (0, min(width, v))


def test_no_bias_matches_jax():
    hidden, kernel, _, labels = _inputs(1, 8, 12, 40, bias=False)
    want, _ = jax_ce(jnp.asarray(hidden), jnp.asarray(kernel), None,
                     jnp.asarray(labels), 4)
    loss, _, _ = _port(hidden, kernel, None, labels, 4)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_argmax_ties_go_to_the_first_index_and_the_earlier_chunk():
    # equal logits across chunks: JAX keeps the earliest (cav > amax_val)
    hidden = np.ones((3, 2), np.float32)
    kernel = np.zeros((2, 12), np.float32)
    kernel[:, [2, 5, 9]] = 1.0  # ties in chunks 0, 1 and 2 (width 4)
    labels = np.zeros(3, np.int32)
    _, want = jax_ce(jnp.asarray(hidden), jnp.asarray(kernel), None,
                     jnp.asarray(labels), 3)
    _, amax, _ = _port(hidden, kernel, None, labels, 3)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(want))
    assert amax.tolist() == [2, 2, 2]


@pytest.mark.parametrize("v,chunks", [(33, 4), (97, 8)])
def test_gradients_match_jax_grad(v, chunks):
    hidden, kernel, bias, labels = _inputs(2, 10, 8, v)
    w = np.random.default_rng(3).normal(size=(10,)).astype(np.float32)

    def f(h, k, b):
        loss, _ = jax_ce(h, k, b, jnp.asarray(labels), num_chunks=chunks)
        return (loss * w).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(kernel), jnp.asarray(bias))
    loss, _, leaves = _port(hidden, kernel, bias, labels, chunks)
    (loss * torch.tensor(w)).sum().backward()
    for name, got, ref in zip(("hidden", "kernel", "bias"), leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_operands_match_the_jax_bf16_call():
    hidden, kernel, bias, labels = _inputs(4, 32, 24, 200)
    want, want_amax = jax_ce(jnp.asarray(hidden, jnp.bfloat16),
                             jnp.asarray(kernel, jnp.bfloat16),
                             jnp.asarray(bias), jnp.asarray(labels), 8)
    loss, amax, _ = _port(hidden, kernel, bias, labels, 8,
                          dtype=torch.bfloat16)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(amax.numpy(), np.asarray(want_amax))
    # a bf16 product would round the logits: far outside that tolerance
    h = torch.tensor(hidden, dtype=torch.bfloat16)
    k = torch.tensor(kernel, dtype=torch.bfloat16)
    rounded = (h @ k).float() + torch.tensor(bias)
    dense = torch.logsumexp(rounded, -1) - rounded[
        torch.arange(32), torch.tensor(labels).long()]
    assert np.abs(dense.numpy() - np.asarray(want)).max() > 1e-4
    loss.sum().backward()  # the backward runs on bf16 operands too


def test_no_saved_tensor_holds_n_by_v():
    n, e, v = 40, 12, 300
    hidden, kernel, bias, labels = _inputs(5, n, e, v)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, leaves = _port(hidden, kernel, bias, labels, 6)
    loss.sum().backward()
    assert sizes and max(sizes) < n * v
    assert n * v not in sizes and max(sizes) == e * v  # the kernel itself


def _tiny_model(seed=0):
    cfg = tlm.CausalLMConfig(vocab_size=97, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_seq_len=32, dtype=torch.float32)
    model = tlm.CausalLM(cfg, param_dtype=torch.float32)
    return model.load_params(tlm.init_params(cfg, seed=seed))


def test_trainer_step_with_vocab_chunks_equals_the_dense_step():
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(6).integers(
        0, 97, (3, 20)).astype(np.int32))}
    steps = {}
    for chunks in (None, 5):
        # sgd: adam's first step would turn the key bias's ~0 gradient
        # (softmax ignores it) into a +-lr move either way
        trainer = ttrainer.Trainer(_tiny_model(),
                                   ttrainer.causal_lm_task(chunks),
                                   tx=make_optimizer(1e-1, optimizer="sgd"))
        state = trainer.init_state()
        _, metrics = trainer.step(state, batch)
        steps[chunks] = (metrics, {k: p.detach().clone()
                                   for k, p in state.params.items()})
    (dm, dp), (cm, cp) = steps[None], steps[5]
    for key in ("loss", "next_token_accuracy"):
        torch.testing.assert_close(cm[key], dm[key], rtol=0, atol=2e-6)
    for name, p in dp.items():
        torch.testing.assert_close(cp[name], p, rtol=0, atol=2e-6,
                                   msg=name)
