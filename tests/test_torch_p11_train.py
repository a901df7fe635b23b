"""PyTorch port, the training mesh against the JAX ``Trainer``: causal-LM
steps of ``Trainer(mesh=)`` in one gloo world of 4 CPU ranks
(``tests/torch_p11_world.py``) against the JAX ``Trainer`` on
``local_mesh_for_testing(4, axes)`` of the same shape, from the same
parameters (each case's JAX init) and batches.

The LM is 2 layers, hidden 64, 4 heads, f32; every batch carries an
``attention_mask`` whose padding differs from row to row, so every rank
holds another count of tokens and the loss must be the global masked
mean. Meshes: ``dp=4``, ``dp=2,fsdp=2``, ``fsdp=2,tp=2``, ``dp=2,tp=2``
and, with 2 KV heads, ``tp=4`` (JAX repeats K/V before the head split);
3 steps of Adam everywhere, and at ``fsdp=2,tp=2`` also of LAMB with
weight decay and global-norm clipping (its trust ratios and the clip's
norm are whole-leaf reductions over shards) and of the chunked-vocabulary
loss (the head gathered over tp).

Tolerances: each step's loss and accuracy within 1e-5 relative of the
JAX step's (f32 sums over ranks and heads in another order). The
parameters after 3 steps: at most 0.1% of each leaf's elements more
than 5e-5 apart (the one-device 3-step test's bound), none more than
3 lr. Adam moves a weight whose gradient is a rounding residual by up
to lr a step on that residual's sign, and the two programs round
apart; the key biases are all such weights (their gradient is 0
analytically: a softmax row is unchanged by a constant added to every
key), so they are held to the 3 lr bound alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.data.pipeline import put_global_batch
from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.parallel.mesh import (batch_sharding,
                                              local_mesh_for_testing)
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu.train.harness import make_optimizer as jax_opt
from pyspark_tf_gke_tpu.utils.seeding import make_rng

from torch_p11_world import run_world

torch.set_num_threads(1)

LM = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
          intermediate_size=128, max_seq_len=32)
ADAM = dict(learning_rate=1e-2)
LAMB = dict(learning_rate=1e-2, optimizer="lamb", weight_decay=0.01,
            grad_clip_norm=0.5)

CASES = {
    "dp4_adam": ({"dp": 4}, {}, ADAM, None),
    "dp2_fsdp2_adam": ({"dp": 2, "fsdp": 2}, {}, ADAM, None),
    "fsdp2_tp2_adam": ({"fsdp": 2, "tp": 2}, {}, ADAM, None),
    "dp2_tp2_adam": ({"dp": 2, "tp": 2}, {}, ADAM, None),
    "gqa_tp4_adam": ({"tp": 4}, {"num_kv_heads": 2}, ADAM, None),
    "fsdp2_tp2_lamb_clip": ({"fsdp": 2, "tp": 2}, {}, LAMB, None),
    "fsdp2_tp2_chunked": ({"fsdp": 2, "tp": 2}, {}, ADAM, 2),
}


def _batches(seed=41, n=3, rows=8, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, LM["vocab_size"], (rows, seq)).astype(np.int32)
        lengths = rng.integers(4, seq + 1, rows)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": mask})
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else
                   {path: np.asarray(v)})
    return out


def _jax_run(axes, extra, opt, chunks, batches):
    mesh = local_mesh_for_testing(4, axes)
    jcfg = jlm.CausalLMConfig(**LM, **extra, dtype=jnp.float32)
    jt = jtrainer.Trainer(jlm.CausalLM(jcfg, mesh=mesh),
                          jtrainer.TASKS["causal_lm"](vocab_chunks=chunks),
                          mesh, tx=jax_opt(**opt))
    state = jt.init_state(make_rng(0), batches[0])
    params = _flat(jax.device_get(state.params))
    metrics = []
    for batch in batches:
        state, m = jt.step(state, put_global_batch(batch,
                                                   batch_sharding(mesh)))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    fields = {**LM, **extra, "dtype": "float32"}
    return params, metrics, _flat(jax.device_get(state.params)), fields


@pytest.fixture(scope="module")
def world(tmp_path_factory, devices):
    batches = _batches()
    payload = {"cases": {}, "params": {}}
    jax_out = {}
    for name, (axes, extra, opt, chunks) in CASES.items():
        params, metrics, final, fields = _jax_run(axes, extra, opt, chunks,
                                                  batches)
        payload["params"][name] = params
        payload["cases"][name] = {"mesh": axes, "cfg": fields, "opt": opt,
                                  "batches": batches, "params": name,
                                  "vocab_chunks": chunks}
        jax_out[name] = (metrics, final)
    ranks = run_world("lm", payload, str(tmp_path_factory.mktemp("p11lm")))
    return jax_out, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_jax_trainer(world, case):
    jax_out, ranks = world
    jmetrics, jfinal = jax_out[case]
    tp = CASES[case][0].get("tp", 1)
    for rank in ranks:  # every rank holds the global metrics
        assert rank[case]["dtensors"] == 0
        # the model computes on this rank's heads: hidden / tp columns
        assert rank[case]["query_shape"] == (LM["hidden_size"],
                                             LM["hidden_size"] // tp)
        got = rank[case]["losses"]
        assert len(got) == len(jmetrics) == 3
        for g, j in zip(got, jmetrics):
            assert g.keys() == j.keys()
            for key in j:
                np.testing.assert_allclose(g[key], j[key], rtol=1e-5,
                                           atol=1e-7, err_msg=key)
    final = ranks[0][case]["params"]
    assert final.keys() == jfinal.keys()
    lr = CASES[case][2]["learning_rate"]
    for path, want in jfinal.items():
        diff = np.abs(final[path] - want)
        assert diff.max() <= 3 * lr, path
        if not path.endswith("attention/key/bias"):
            assert (diff > 5e-5).mean() <= 1e-3, (path, diff.max())
    for rank in ranks[1:]:  # the gathered state is the same everywhere
        for path, value in rank[case]["params"].items():
            np.testing.assert_array_equal(value, final[path], err_msg=path)
