"""PyTorch port, the three training CLIs over 2 processes: one gloo world
of 2 CPU ranks (``tests/torch_p11_world.py``) runs ``train/cli.py`` (the
MLP on a synthetic CSV at ``--mesh-shape fsdp=2``, its kernels split by
a small ``FSDP_MIN_SIZE``), ``lm_pretrain`` (``tp=2``, with an eval
set) and ``bert_finetune`` (``sp=2``: the ring attention over the mesh),
each with ``--num-processes 2``; the first joins the world through
``--process-id`` and the coordinator flags. Each history equals the
same CLI's one-process history (no mesh flags) in this process: every
key but the timings within 1e-5 relative. Each rank beats its own
``heartbeat-{process_index}.json``; rank 0 writes the artifacts.

The lm_pretrain eval split follows the JAX rule: at ``dp=2`` an eval
set of three files, which does not divide over the two data shards,
exits on every rank before training.
"""

import json
import os

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu_torch.data.synthetic import make_synthetic_csv
from pyspark_tf_gke_tpu_torch.data.tfrecord import write_tfrecord_shards
from torch_p11_world import run_world

torch.set_num_threads(1)

TIMING = ("step_time_ms", "examples_per_sec")
ENV = {"FSDP_MIN_SIZE": "64"}


def _corpus(root, n_files=2, seed=5):
    root.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        text = "\n\n".join("".join(chr(rng.integers(97, 123)) for _ in range(
            rng.integers(40, 200))) for _ in range(30))
        (root / f"{i}.txt").write_text(text)
    return str(root / "*.txt")


def _shards(root, n=64, seq=16, vocab=64, seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (n, seq)).astype(np.int64)
    lengths = rng.integers(6, seq + 1, n)
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int64)
    labels = (ids[:, 0] >= vocab // 2).astype(np.int64)
    write_tfrecord_shards({"input_ids": ids * mask, "attention_mask": mask,
                           "label": labels}, str(root / "train"),
                          num_shards=2)
    return str(root / "train-*.tfrecord")


def _runs(tmp, out):
    csv = str(tmp / "d.csv")
    make_synthetic_csv(csv, rows=160)
    text = _corpus(tmp / "corpus")
    evals = _corpus(tmp / "eval", seed=7)
    shards = _shards(tmp)
    runs = {
        "cli": ("pyspark_tf_gke_tpu_torch.train.cli", [
            "--data-path", csv, "--batch-size", "16", "--epochs", "2",
            "--device", "cpu", "--heartbeat-every-steps", "1"], "fsdp=2"),
        "lm_pretrain": ("pyspark_tf_gke_tpu_torch.train.lm_pretrain", [
            "--data-pattern", text, "--eval-pattern", evals,
            "--eval-batches", "2", "--seq-len", "32", "--hidden-size", "32",
            "--num-layers", "1", "--num-heads", "2",
            "--intermediate-size", "64", "--epochs", "2",
            "--steps-per-epoch", "2", "--batch-size", "8",
            "--compute-dtype", "float32", "--device", "cpu",
            "--heartbeat-every-steps", "1"], "tp=2"),
        "bert_finetune": ("pyspark_tf_gke_tpu_torch.train.bert_finetune", [
            "--data-pattern", shards, "--seq-len", "16", "--vocab-size",
            "64", "--hidden-size", "32", "--num-layers", "2",
            "--num-heads", "4", "--intermediate-size", "64",
            "--compute-dtype", "float32", "--epochs", "2",
            "--steps-per-epoch", "2", "--batch-size", "8",
            "--learning-rate", "3e-3", "--device", "cpu",
            "--heartbeat-every-steps", "1"], "sp=2"),
    }
    mesh_runs, solo_runs = {}, {}
    for name, (module, argv, mesh) in runs.items():
        mesh_runs[name] = (module, argv + [
            "--output-dir", str(out / name), "--mesh-shape", mesh,
            "--num-processes", "2", "--process-id", "{rank}",
            "--coordinator-addr", "127.0.0.1", "--coordinator-port",
            "{port}"])
        solo_runs[name] = (module, argv + ["--output-dir",
                                           str(tmp / "solo" / name)])
    # three eval files over two data shards: the JAX rule exits
    module, argv = mesh_runs["lm_pretrain"]
    odd = _corpus(tmp / "eval3", n_files=3, seed=8)
    mesh_runs["lm_uneven_eval"] = (module, [
        odd if a == evals else ("dp=2" if a == "tp=2" else a) for a in argv])
    return mesh_runs, solo_runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import importlib

    tmp = tmp_path_factory.mktemp("p11cli")
    out = tmp / "mesh"
    mesh_runs, solo_runs = _runs(tmp, out)
    ranks = run_world("cli", {"runs": mesh_runs, "env": ENV}, str(tmp),
                      world=2)
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    try:
        solo = {name: importlib.import_module(module).main(argv)
                for name, (module, argv) in solo_runs.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ranks, solo, out


@pytest.mark.parametrize("name", ["cli", "lm_pretrain", "bert_finetune"])
def test_cli_over_two_processes_matches_one(runs, name):
    ranks, solo, out = runs
    want = solo[name]
    assert "loss" in want
    for rank in ranks:
        got = rank[name]
        assert set(got) == set(want)
        for key, values in want.items():
            if key in TIMING:
                continue
            np.testing.assert_allclose(got[key], values, rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    run_dir = out / name
    for r in range(2):  # each rank's own heartbeat
        beat = json.loads((run_dir / f"heartbeat-{r}.json").read_text())
        assert beat["process_index"] == r and beat["process_count"] == 2
    history = json.loads((run_dir / "history.json").read_text())
    assert history["loss"] == pytest.approx(ranks[0][name]["loss"])
    notes = next(p for p in run_dir.iterdir() if p.suffix == ".txt")
    assert "processes: 2" in notes.read_text()


def test_lm_eval_files_must_split_over_data_shards(runs):
    ranks, _, _ = runs
    for rank in ranks:
        assert "does not divide evenly" in rank["lm_uneven_eval"]
