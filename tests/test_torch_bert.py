"""PyTorch port, BERT fine-tuning on the CPU against the JAX package:
``BertForPretraining`` logits (MLM and classification, dense and flash
attention) from the JAX model's parameters through
``bert_params_from_flax``; step-0 loss and gradients of both BERT tasks
and one ``Trainer`` step of each against the JAX ``Trainer``;
``bert_finetune.main`` on codec shards (falling loss, artifacts,
resume) and its refused flags (``--num-experts`` runs since the MoE FFN
was ported: ``test_torch_p10_moe.py``).

Tolerances, all f32: logits within 1e-5 (two layers of products summed
in another order; logits are O(1)); losses within 1e-5 and gradients
within 1e-4 absolute + 1e-4 relative (the same products through the
backward, gradients O(1e-3..1)); after one SGD step at lr 0.1 the
parameters within 2e-5 (the gradient tolerance times the rate).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models.bert import BertConfig as JaxBertConfig
from pyspark_tf_gke_tpu.models.bert import BertForPretraining as JaxBert
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu_torch.data.mlm import mlm_batches
from pyspark_tf_gke_tpu_torch.data.tfrecord import write_tfrecord_shards
from pyspark_tf_gke_tpu_torch.models import bert as tb
from pyspark_tf_gke_tpu_torch.train import bert_finetune
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

torch.set_num_threads(1)

LOGIT_ATOL, LOSS_ATOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4
SEQ, VOCAB = 16, 128  # [MASK] = 103 lies inside the vocabulary
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=64)


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32)
    mask = np.ones((b, SEQ), np.int32)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def _jax_params(cfg, batch, seed=1):
    model = JaxBert(cfg)
    return model, jax.device_get(nn.meta.unbox(model.init(
        jax.random.key(seed), jnp.asarray(batch["input_ids"]),
        attention_mask=jnp.asarray(batch["attention_mask"]))["params"]))


def _port(params, use_flash=None, trainable=True):
    model = tb.BertForPretraining(
        tb.BertConfig(**CFG, dtype=torch.float32, use_flash=use_flash),
        param_dtype=torch.float32 if trainable else None)
    return model.load_params(tb.bert_params_from_flax(params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("use_flash", [None, True], ids=["dense", "flash"])
def test_logits_equal_the_jax_model(use_flash):
    batch = _batch()
    batch["attention_mask"][3] = 0  # a row with no key at all
    jcfg = JaxBertConfig(**CFG, dtype=jnp.float32, use_flash=use_flash)
    jmodel, params = _jax_params(jcfg, batch)
    want = jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(batch["input_ids"]),
        attention_mask=jnp.asarray(batch["attention_mask"]))
    model = _port(params, use_flash, trainable=False)
    assert set(model.flax_parameters()) == set(_flat(params))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]),
                    attention_mask=torch.from_numpy(batch["attention_mask"]))
    for key in ("mlm_logits", "cls_logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=LOGIT_ATOL, err_msg=key)
    assert float(got["aux_loss"]) == 0.0


def _task_batch(task, seed):
    batch = _batch(seed=seed)
    if task == "bert_mlm":
        mlm = next(mlm_batches(iter([batch]), VOCAB, seed=seed,
                               mask_prob=0.3))
        batch = {k: mlm[k] for k in ("input_ids", "attention_mask",
                                     "mlm_labels")}
    return batch


@pytest.mark.parametrize("task", ["bert_classification", "bert_mlm"])
def test_step0_gradients_and_one_step_equal_the_jax_trainer(task, devices):
    from pyspark_tf_gke_tpu.data.pipeline import put_global_batch
    from pyspark_tf_gke_tpu.parallel.mesh import batch_sharding, make_mesh
    from pyspark_tf_gke_tpu.train.harness import (
        make_optimizer as jax_make_optimizer)
    from pyspark_tf_gke_tpu.utils.seeding import make_rng

    batch = _task_batch(task, seed=2)
    jcfg = JaxBertConfig(**CFG, dtype=jnp.float32)
    mesh = make_mesh({"dp": 1}, devices[:1])
    jt = jtrainer.Trainer(JaxBert(jcfg, mesh=mesh), jtrainer.TASKS[task](),
                          mesh, tx=jax_make_optimizer(0.1, optimizer="sgd"))
    state = jt.init_state(make_rng(0), batch)
    params = jax.device_get(state.params)
    jtask = jtrainer.TASKS[task]()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        preds, _ = jtask.forward(jt.model, {"params": p}, jbatch, True, False)
        return jtask.loss_and_metrics(preds, jbatch)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(params)
    jgrads = _flat(jax.device_get(jgrads))

    model = _port(params)
    ttask = ttrainer.TASKS[task]()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ttask.loss_and_metrics(ttask.forward(model, tbatch), tbatch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=LOSS_ATOL)
    # the other task's head takes no gradient: None here, zeros in JAX
    got = {path: p.grad if p.grad is not None else torch.zeros_like(p)
           for path, p in model.flax_parameters().items()}
    assert set(got) == set(jgrads)
    for path, g in got.items():
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(jgrads[path]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)
    model.zero_grad(set_to_none=True)

    # one Trainer step each: the metrics, then the parameters
    state, jm = jt.step(state, put_global_batch(batch, batch_sharding(mesh)))
    tt = ttrainer.Trainer(model, ttrainer.TASKS[task](),
                          tx=make_optimizer(0.1, optimizer="sgd"))
    tstate, tm = tt.step(tt.init_state(), tbatch)
    jm = jax.device_get(jm)
    assert set(tm) == set(jm)
    for key in tm:
        assert float(tm[key]) == pytest.approx(float(jm[key]), abs=LOSS_ATOL)
    jparams = _flat(jax.device_get(state.params))
    for path, p in model.flax_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[path],
                                   atol=2e-5, err_msg=path)


def _shards(tmp_path, n=160, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, (n, SEQ)).astype(np.int64)
    lengths = rng.integers(6, SEQ + 1, n)
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int64)
    # a learnable label: whether the first token is in the upper half
    labels = (ids[:, 0] >= VOCAB // 2).astype(np.int64)
    prefix = str(tmp_path / "shards" / "train")
    write_tfrecord_shards({"input_ids": ids * mask, "attention_mask": mask,
                           "label": labels}, prefix, num_shards=4)
    return f"{prefix}-*.tfrecord"


def _args(pattern, out, *extra):
    return ["--data-pattern", pattern, "--output-dir", str(out),
            "--seq-len", str(SEQ), "--vocab-size", str(VOCAB),
            "--hidden-size", "32", "--num-layers", "2", "--num-heads", "4",
            "--intermediate-size", "64", "--compute-dtype", "float32",
            "--epochs", "2", "--steps-per-epoch", "6", "--batch-size", "16",
            "--learning-rate", "3e-3", "--device", "cpu",
            "--checkpoint-every-steps", "6", *extra]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """parse_args defaults come from the environment."""
    for var in ("DATA_PATTERN", "NUM_PROCESSES", "MESH_SHAPE", "OUTPUT_DIR",
                "EPOCHS", "BATCH_SIZE", "MAX_RESTARTS", "OBJECTIVE",
                "DEVICE", "NUM_EXPERTS"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("objective", ["classification", "mlm"])
def test_bert_finetune_main_on_codec_shards(tmp_path, objective):
    pattern = _shards(tmp_path)
    out = tmp_path / "run"
    hist = bert_finetune.main(_args(pattern, out, "--objective", objective))
    keys = ({"loss", "accuracy"} if objective == "classification"
            else {"loss", "mlm_accuracy", "masked_frac"})
    assert keys | {"moe_aux_loss", "step_time_ms",
                   "examples_per_sec"} == set(hist)
    assert all(len(v) == 2 and np.isfinite(v).all() for v in hist.values())
    assert hist["loss"][1] < hist["loss"][0]
    assert json.loads((out / "history.json").read_text()) == hist
    notes = (out / "bert-finetune.txt").read_text()
    assert "final step: 12" in notes
    assert sorted(p.name for p in (out / "checkpoints").iterdir()
                  if p.name.isdigit()) == ["12", "6"]
    assert (out / "heartbeat-0.json").exists() or any(
        p.name.startswith("heartbeat") for p in out.iterdir())
    if objective == "classification":
        # resume continues the step count from the latest checkpoint
        bert_finetune.main(_args(pattern, out, "--resume", "--epochs", "1"))
        assert "final step: 18" in (out / "bert-finetune.txt").read_text()


def test_bert_finetune_refuses_unported_flags(tmp_path):
    base = ["--data-pattern", str(tmp_path / "*.tfrecord"), "--device", "cpu"]
    # the axes of the next slice raise, naming it
    for flags in (["--mesh-shape", "pp=2"], ["--dcn-mesh-shape", "ep=2"],
                  ["--mesh-shape", "sp=2", "--num-experts", "4"]):
        with pytest.raises(NotImplementedError, match="P11c"):
            bert_finetune.main(base + flags)
    with pytest.raises(SystemExit):
        bert_finetune.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="sp_impl"):
        tb.BertConfig(sp_impl="tree")
