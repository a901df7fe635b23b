"""Trained target/draft pair for speculative decoding (counterpart of
``pyspark_tf_gke_tpu/train/spec_fixture.py``).

Random weights give near-zero acceptance and a self-draft gives exactly
1.0; neither resembles a deployed draft/target pair. This module trains
a tiny byte-level target and a smaller draft on the SAME low-entropy
synthetic text — sentences from a first-order Markov chain over a dozen
words, its first successor favoured with probability ``skew`` — so the
draft's greedy proposals agree with the target's often but not always.
The text and the row packing use numpy's ``default_rng`` exactly as the
JAX module does (the same rows bit for bit); the training loop is a
plain Adam loop in f32 on the given device, its step one CUDA graph on
the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.data.text import ByteTokenizer

# word -> possible successors: branching, so a smaller model stays
# imperfect on it
_CHAIN = {
    "the": ["tpu", "mesh", "ring", "chip"],
    "tpu": ["shards", "runs", "compiles"],
    "mesh": ["shards", "holds"],
    "ring": ["passes", "runs"],
    "chip": ["runs", "holds"],
    "shards": ["the"],
    "runs": ["the", "fast", "."],
    "holds": ["the"],
    "passes": ["the"],
    "compiles": ["the", "fast", "."],
    "fast": ["."],
    ".": ["the"],
}


def synthetic_text(n_chars: int, seed: int = 0,
                   skew: float = 0.75) -> str:
    """At least ``n_chars`` characters of the chain's sentences: the
    first successor drawn with probability ``skew``, the rest uniform.
    The skew gives both models the same learnable ranking at a branch,
    so greedy agreement does not hang on near-ties."""
    rng = np.random.default_rng(seed)
    words, word = [], "the"
    total = 0
    while total < n_chars:
        words.append(word)
        total += len(word) + 1
        succ = _CHAIN[word]
        if len(succ) == 1:
            word = succ[0]
        else:
            rest = (1.0 - skew) / (len(succ) - 1)
            p = np.asarray([skew] + [rest] * (len(succ) - 1))
            word = succ[int(rng.choice(len(succ), p=p))]
    return " ".join(words)


def _pack_rows(seq_len: int, n_rows: int, seed: int = 0,
               skew: float = 0.75) -> np.ndarray:
    """[n_rows, seq_len] int32 byte tokens cut from one generated stream."""
    stream = np.asarray(
        ByteTokenizer().encode(synthetic_text(seq_len * (n_rows + 1),
                                              seed=seed, skew=skew)),
        dtype=np.int32)
    need = seq_len * n_rows
    assert stream.size >= need, "generator under-produced"
    return stream[:need].reshape(n_rows, seq_len)


# training steps run eagerly on a side stream before a step is captured
_WARMUP_STEPS = 3


def _train_lm(model, rows: np.ndarray, steps: int, lr: float):
    """``steps`` Adam steps over the fixed rows, one row a step in turn,
    on ``model``'s device; returns the model in eval mode. ``model``
    holds trainable f32 weights (``param_dtype=torch.float32``), set
    before the call (``init_params``, which takes the JAX function's
    seed). f32 matmuls run without TF32:
    the JAX fixture trains at "highest" precision because reduced-
    precision passes shift these tiny models' near-argmax logits enough
    to change greedy agreements, and acceptance must mean the same on
    every backend.

    On CUDA the step is one CUDA graph, as the JAX fixture's loop is one
    jitted ``lax.scan``: the first steps run eagerly on a side stream
    (the optimizer's state is made there), the next one is captured —
    forward, backward and the Adam update over gradients the graph owns
    — and replayed for the rest with each row copied into the step's
    input. The CPU runs every step eagerly. The update rule is the same;
    the captured update keeps its step count on the device and rounds
    otherwise (``capturable=True``), so a trained pair differs between
    the two in its last bits, and so can its acceptance."""
    device = model.device
    data = torch.as_tensor(np.asarray(rows), dtype=torch.long, device=device)
    params = [p for p in model.parameters() if p.requires_grad]
    cuda = device.type == "cuda"
    opt = torch.optim.Adam(params, lr=lr, capturable=cuda)
    ids = data[:1].clone()  # the step's input, written in place

    def step():
        logits = model(ids)[:, :-1].float()
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))
        loss.backward()
        opt.step()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model.train()
        eager = steps if not cuda else min(steps, _WARMUP_STEPS)
        side = torch.cuda.Stream(device) if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(device))
        with (torch.cuda.stream(side) if cuda
              else contextlib.nullcontext()):
            for i in range(eager):
                ids.copy_(data[i % data.shape[0]][None])
                opt.zero_grad(set_to_none=True)
                step()
        if cuda and steps > eager:
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            opt.zero_grad(set_to_none=True)
            with torch.cuda.graph(graph):
                step()
            for i in range(eager, steps):
                ids.copy_(data[i % data.shape[0]][None])
                graph.replay()
            torch.cuda.current_stream(device).synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return model.eval()


def make_spec_fixture(steps: int = 1500, seq_len: int = 64, seed: int = 0,
                      skew: float = 0.75, device="cuda") -> Tuple:
    """``(target, draft, prompt)``: a trained 2-layer h64 byte target, a
    trained 1-layer h32 draft (same data), both f32 serving models on
    ``device``, and an in-distribution prompt row ``[1, 16]``.
    Deterministic by seed on one device."""
    from pyspark_tf_gke_tpu_torch.device import resolve_device
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)

    device = resolve_device(device)
    common = dict(vocab_size=259, intermediate_size=128, max_seq_len=256,
                  dtype=torch.float32)
    tcfg = CausalLMConfig(hidden_size=64, num_layers=2, num_heads=4,
                          **common)
    dcfg = dataclasses.replace(tcfg, hidden_size=32, num_layers=1,
                               num_heads=2, intermediate_size=64)
    rows = _pack_rows(seq_len, n_rows=32, seed=seed, skew=skew)
    trained = []
    for cfg, s in ((tcfg, seed), (dcfg, seed + 1)):
        with torch.device(device):
            m = CausalLM(cfg, param_dtype=torch.float32)
        m.load_params(init_params(cfg, seed=s))
        _train_lm(m, rows, steps, lr=3e-3)
        with torch.device(device):
            served = CausalLM(cfg)
        served.load_state_dict(m.state_dict())
        trained.append(served.eval())
    prompt = _pack_rows(16, n_rows=1, seed=seed + 2, skew=skew)
    return trained[0], trained[1], prompt
