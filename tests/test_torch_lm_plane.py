"""PyTorch port, the rest of the LM training plane on the CPU against the
JAX package: packed-token shards (``etl/text_bridge.py``), object-store
paths on fsspec's ``memory://`` filesystem (``utils/fs.py``), the
``lm_pretrain`` flags ``--data-format tokens``, ``--vocab-chunks``,
``--optimizer lamb|adafactor`` and ``--async-checkpoint`` with a remote
output directory, asynchronous checkpoints, and the trainer's metrics
and event trail.

Shard bytes are compared exactly; the JAX native reader reads the
port's shards and the port's reader the JAX ones (the same rows). The
JAX ``lm_pretrain`` runs the same flags on a local directory (orbax
writes no ``memory://``): both histories have the same keys and finite
values.
"""

import json
import os
from pathlib import Path

import fsspec
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.data import native_tfrecord as jtfr
from pyspark_tf_gke_tpu.etl import text_bridge as jbridge
from pyspark_tf_gke_tpu.train.harness import make_heartbeat as jax_heartbeat
from pyspark_tf_gke_tpu.train.lm_pretrain import main as jax_main
from pyspark_tf_gke_tpu_torch.data import tfrecord as ttfr
from pyspark_tf_gke_tpu_torch.etl import text_bridge as tbridge
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.obs.events import EventLog
from pyspark_tf_gke_tpu_torch.obs.metrics import MetricsRegistry
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.train.harness import make_heartbeat
from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main
from pyspark_tf_gke_tpu_torch.utils import fs as tfs

torch.set_num_threads(1)

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda "
         "mu nu xi omicron pi rho sigma tau upsilon").split()
SCHEMA = {"input_ids": ("int", (32,))}
TINY_FLAGS = ["--hidden-size", "32", "--num-layers", "2", "--num-heads", "4",
              "--intermediate-size", "64", "--seq-len", "32",
              "--batch-size", "8", "--compute-dtype", "float32",
              "--learning-rate", "1e-3", "--seed", "0"]


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(20, 60)))
            + (" é" if i % 3 == 0 else "") for i in range(n)]


def _memfs():
    return fsspec.filesystem("memory")


@pytest.fixture
def bucket(request):
    name = f"memory://lmplane-{request.node.name[:40]}"
    yield name
    fs = _memfs()
    root = name.split("://", 1)[1]
    if fs.exists(root):
        fs.rm(root, recursive=True)


def _write_shards(bridge, prefix, docs, shards=2):
    if "://" not in prefix:
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
    paths = []
    for i in range(shards):
        paths += list(bridge.tokenize_partition_docs(
            i, docs[i::shards], prefix, 32, num_shards=shards))
    bridge.write_shard_metadata(prefix, 32)
    return paths


def _rows(batches):
    return np.concatenate([b["input_ids"] for b in batches])


def test_token_shards_match_and_cross_read(tmp_path):
    docs = _docs(80, 0) + [None, ""]
    tpaths = _write_shards(tbridge, str(tmp_path / "t" / "lm"), docs)
    jpaths = _write_shards(jbridge, str(tmp_path / "j" / "lm"), docs)
    for tp, jp in zip(tpaths, jpaths):
        assert Path(tp).read_bytes() == Path(jp).read_bytes()
    assert json.loads((tmp_path / "t" / "lm.meta.json").read_text()) == \
        json.loads((tmp_path / "j" / "lm.meta.json").read_text())
    # each package reads the other's shards: the same rows
    port_reads_jax = _rows(ttfr.read_tfrecord_batches(
        str(tmp_path / "j" / "lm-*.tfrecord"), SCHEMA, 4, shuffle=False,
        repeat=False))
    jax_reads_port = _rows(jtfr.read_tfrecord_batches(
        str(tmp_path / "t" / "lm-*.tfrecord"), SCHEMA, 4, shuffle=False,
        repeat=False, process_index=0, process_count=1, nthreads=1))
    assert port_reads_jax.dtype == np.int32 and port_reads_jax.shape[1] == 32
    np.testing.assert_array_equal(np.sort(port_reads_jax, axis=0),
                                  np.sort(jax_reads_port, axis=0))


def test_remote_shards_spool_and_read(bucket, tmp_path):
    docs = _docs(60, 1)
    prefix = f"{bucket}/shards/lm"
    paths = _write_shards(tbridge, prefix, docs)
    assert all(p.startswith("memory://") for p in paths)
    found = tfs.fs_glob(f"{prefix}-*.tfrecord")
    assert all(p.startswith("memory://") for p in found)  # scheme kept
    assert [p.rsplit("/", 1)[1] for p in found] == sorted(
        p.rsplit("/", 1)[1] for p in paths)
    local = _write_shards(tbridge, str(tmp_path / "lm"), docs)
    spool = tmp_path / "spool"
    staged = tfs.spool_local(paths[0], str(spool))
    assert Path(staged).read_bytes() == Path(local[0]).read_bytes()
    assert tfs.spool_local(paths[0], str(spool)) == staged  # reused
    tbridge.validate_shard_meta(f"{prefix}-*.tfrecord", "byte", 32, 259)
    np.testing.assert_array_equal(
        _rows(ttfr.read_tfrecord_batches(f"{prefix}-*.tfrecord", SCHEMA, 4,
                                         shuffle=False, repeat=False)),
        _rows(ttfr.read_tfrecord_batches(str(tmp_path / "lm-*.tfrecord"),
                                         SCHEMA, 4, shuffle=False,
                                         repeat=False)))


@pytest.mark.parametrize("tokenizer,seq_len,vocab", [
    ("gpt2", 32, 259), ("byte", 64, 259), ("byte", 32, 100)])
def test_sidecar_mismatch_raises_as_in_jax(tmp_path, tokenizer, seq_len,
                                           vocab):
    _write_shards(tbridge, str(tmp_path / "lm"), _docs(30, 2))
    pattern = str(tmp_path / "lm-*.tfrecord")
    with pytest.raises(ValueError) as want:
        jbridge.validate_shard_meta(pattern, tokenizer, seq_len, vocab)
    with pytest.raises(ValueError) as got:
        tbridge.validate_shard_meta(pattern, tokenizer, seq_len, vocab)
    assert str(got.value) == str(want.value)
    assert "token-shard contract mismatch" in str(got.value)
    os.remove(tmp_path / "lm.meta.json")  # no sidecar: a warning only
    tbridge.validate_shard_meta(pattern, tokenizer, seq_len, vocab)


def test_lm_pretrain_tokens_chunks_lamb_async_remote(bucket, tmp_path):
    shards = str(tmp_path / "shards" / "lm")
    _write_shards(tbridge, shards, _docs(120, 3))
    flags = ["--data-pattern", f"{shards}-*.tfrecord", "--data-format",
             "tokens", *TINY_FLAGS, "--vocab-chunks", "4", "--optimizer",
             "lamb", "--weight-decay", "0.01", "--async-checkpoint",
             "--checkpoint-every-steps", "3", "--epochs", "2",
             "--steps-per-epoch", "3", "--heartbeat-every-steps", "1"]
    jhist = jax_main(flags + ["--output-dir", str(tmp_path / "jax")])
    out = f"{bucket}/run"
    # with a remote output directory the default heartbeat is node-local
    # /tmp, per process, in both packages (the runs below name a file
    # under tmp_path instead, so the test writes nothing outside it)
    assert make_heartbeat(out, 1).path == "/tmp/tpu-heartbeat-0.json"
    assert jax_heartbeat(out, 1).path.replace(
        "{process_index}", "0") == "/tmp/tpu-heartbeat-0.json"
    flags += ["--heartbeat-file", str(tmp_path / "hb-{process_index}.json")]
    hist = main(flags + ["--output-dir", out, "--device", "cpu"])
    assert set(hist) == set(jhist)
    assert all(len(v) == 2 and np.isfinite(v).all() for v in hist.values())
    fs = _memfs()
    root = out.split("://", 1)[1]
    assert json.loads(fs.cat(f"{root}/history.json")) == hist
    assert json.loads(fs.cat(f"{root}/checkpoints/history.json")) == hist
    assert "final step: 6" in fs.cat(f"{root}/causal-lm.txt").decode()
    ckpt = CheckpointManager(f"{out}/checkpoints")
    assert ckpt.all_steps() == [3, 6]
    assert not any(".tmp" in p for p in fs.find(root))
    assert json.loads((tmp_path / "hb-0.json").read_text())["step"] == 6
    # --resume continues from the last save, on another optimizer too
    main(flags + ["--output-dir", out, "--device", "cpu", "--resume",
                  "--epochs", "1"])
    assert "final step: 9" in fs.cat(f"{root}/causal-lm.txt").decode()
    assert ckpt.all_steps() == [3, 6, 9]
    # adafactor on the dense loss, without weight decay (the JAX trainer
    # cannot place adafactor's state: ROADMAP, "Reference-side caveats";
    # the update is held to optax in test_torch_optimizers.py)
    hist = main(flags[:flags.index("--vocab-chunks")] + [
        "--optimizer", "adafactor", "--epochs", "1", "--steps-per-epoch",
        "3", "--output-dir", str(tmp_path / "adafactor"), "--device", "cpu"])
    assert np.isfinite(hist["loss"]).all()


def _tiny_trainer(registry=None, event_log=None):
    cfg = tlm.CausalLMConfig(vocab_size=61, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_seq_len=16, dtype=torch.float32)
    model = tlm.CausalLM(cfg, param_dtype=torch.float32)
    model.load_params(tlm.init_params(cfg, seed=3))
    return ttrainer.Trainer(model, ttrainer.causal_lm_task(),
                            learning_rate=1e-2, metrics_registry=registry,
                            event_log=event_log)


def _batch(seed=0):
    return {"input_ids": torch.from_numpy(np.random.default_rng(seed).integers(
        0, 61, (2, 16)).astype(np.int32))}


@pytest.mark.parametrize("remote", [False, True])
def test_async_save_keeps_the_values_from_before_the_update(
        remote, bucket, tmp_path):
    trainer = _tiny_trainer()
    state = trainer.init_state()
    trainer.step(state, _batch())
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    saved_mu = {k: t.clone() for k, t in state.opt_state["mu"].items()}
    directory = f"{bucket}/ck" if remote else str(tmp_path / "ck")
    ckpt = CheckpointManager(directory, async_save=True)
    ckpt.save(state, {"loss": [1.0]})
    assert ckpt.latest_step() == 1
    trainer.step(state, _batch(1))  # updates params and moments in place
    ckpt.wait()
    assert ckpt.all_steps() == [1]
    other = _tiny_trainer().init_state()
    restored = ckpt.restore(other)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for k, p in saved.items():
        torch.testing.assert_close(restored.params[k], p, rtol=0, atol=0)
        torch.testing.assert_close(restored.opt_state["mu"][k], saved_mu[k],
                                   rtol=0, atol=0)
    history = (json.loads(_memfs().cat(f"{directory.split('://')[1]}"
                                       "/history.json"))
               if remote else json.loads((tmp_path / "ck" /
                                          "history.json").read_text()))
    assert history == {"loss": [1.0]}
    ckpt.close()


def test_fit_feeds_the_train_metrics_and_events(tmp_path):
    registry = MetricsRegistry()
    events = EventLog(str(tmp_path / "events.jsonl"))
    trainer = _tiny_trainer(registry, events)
    state = trainer.init_state()
    batches = (_batch(i) for i in range(100))
    _, history = trainer.fit(state, batches, epochs=2, steps_per_epoch=3)
    snap = registry.snapshot()
    assert snap["train_steps_total"] == 6
    assert snap["train_examples_total"] == 12
    assert snap["train_epochs_total"] == 2
    assert snap["train_last_loss"] == pytest.approx(history["loss"][-1])
    # each epoch's first step is left out of the histogram
    assert snap["train_step_time_ms"]["count"] == 4
    kinds = [json.loads(line) for line in
             (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [k["kind"] for k in kinds] == ["train_fit_start",
                                          "train_epoch_end",
                                          "train_epoch_end"]
    assert kinds[0]["steps_per_epoch"] == 3 and kinds[0]["start_step"] == 0
    assert [k["global_step"] for k in kinds[1:]] == [3, 6]
    assert kinds[2]["loss"] == pytest.approx(history["loss"][-1])


@pytest.mark.parametrize("optimizer", ["lamb", "adafactor"])
def test_bert_finetune_takes_the_new_optimizers_and_async_saves(
        tmp_path, optimizer, monkeypatch):
    from pyspark_tf_gke_tpu.train.bert_finetune import main as jax_bert
    from pyspark_tf_gke_tpu_torch.train import bert_finetune

    for var in ("DATA_PATTERN", "NUM_PROCESSES", "OUTPUT_DIR", "OPTIMIZER"):
        monkeypatch.delenv(var, raising=False)
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 128, (96, 16)).astype(np.int64)
    prefix = str(tmp_path / "shards" / "train")
    ttfr.write_tfrecord_shards(
        {"input_ids": ids, "attention_mask": np.ones_like(ids),
         "label": (ids[:, 0] >= 64).astype(np.int64)}, prefix, num_shards=2)
    flags = ["--data-pattern", f"{prefix}-*.tfrecord", "--seq-len", "16",
             "--vocab-size", "128", "--hidden-size", "32", "--num-layers",
             "2", "--num-heads", "4", "--intermediate-size", "64",
             "--compute-dtype", "float32", "--epochs", "2",
             "--steps-per-epoch", "3", "--batch-size", "16",
             "--optimizer", optimizer, "--weight-decay", "0.01",
             "--async-checkpoint", "--checkpoint-every-steps", "3"]
    out = tmp_path / "port"
    hist = bert_finetune.main(flags + ["--output-dir", str(out),
                                       "--device", "cpu"])
    if optimizer == "lamb":
        # the JAX trainer cannot place adafactor's rank-1 second moments
        # under a matrix's sharding (ROADMAP, "Reference-side caveats");
        # the update itself is held to optax in test_torch_optimizers.py
        jhist = jax_bert(flags + ["--output-dir", str(tmp_path / "jax")])
        assert set(hist) == set(jhist)
    assert all(np.isfinite(v).all() for v in hist.values())
    assert CheckpointManager(str(out / "checkpoints")).all_steps() == [3, 6]
    assert json.loads((out / "checkpoints" / "history.json").read_text()) \
        == hist
