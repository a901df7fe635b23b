"""PyTorch port, the reference-parity training CLI against the JAX one at
tiny sizes: CSV mode (the MLP) and image mode (CNN-B1 at 32x40) write
the same artifacts (``label_map.json`` equal, ``history.json`` with the
same keys and epochs, the run notes' final step, the checkpoint steps),
the same refusals (``--model`` in the wrong mode; the port also refuses
the options that need several processes or devices, and ``cuda`` without
a card), ``--profile-dir``, the ``Config`` flags, and
``ManualImageChecker``: ``predict`` equals the model's forward on the
checkpoint's parameters, ``main`` the errors of those predictions.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.train import cli as jcli
from pyspark_tf_gke_tpu.utils import config as jconfig
from pyspark_tf_gke_tpu_torch.data.images import list_labeled_images, load_image
from pyspark_tf_gke_tpu_torch.data.synthetic import (
    make_synthetic_csv, make_synthetic_image_dataset)
from pyspark_tf_gke_tpu_torch.evaluate import image_checker
from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
from pyspark_tf_gke_tpu_torch.train import cli
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.utils import config

torch.set_num_threads(1)

H, W = 32, 40


def _notes(out: Path, name: str) -> dict:
    lines = (out / f"{name}.txt").read_text().splitlines()
    return dict(line.split(": ", 1) for line in lines)


def _steps(out: Path):
    return sorted(int(p.name) for p in (out / "checkpoints").iterdir()
                  if p.name.isdigit())


def _run_both(tmp_path, args, name):
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    jh = jcli.main(args + ["--output-dir", str(jout)])
    th = cli.main(args + ["--output-dir", str(tout), "--device", "cpu"])
    assert sorted(jh) == sorted(th)
    for key in th:
        assert len(th[key]) == len(jh[key]), key
    assert all(np.isfinite(th["loss"]))
    assert json.loads((tout / "history.json").read_text()) == th
    jn, tn = _notes(jout, name), _notes(tout, name)
    assert tn["final step"] == jn["final step"]
    assert tn["epochs recorded"] == jn["epochs recorded"]
    assert tn["total params"] == jn["total params"]
    assert _steps(tout) == _steps(jout)
    return jout, tout, th


def test_csv_mode_matches_the_jax_cli(tmp_path):
    csv = str(tmp_path / "d.csv")
    make_synthetic_csv(csv, rows=420, missing_rate=0.2)
    jout, tout, history = _run_both(tmp_path, [
        "--data-path", csv, "--epochs", "2", "--batch-size", "16",
        "--checkpoint-every-steps", "1", "--heartbeat-every-steps", "4"],
        "mlp")
    assert ((tout / "label_map.json").read_text()
            == (jout / "label_map.json").read_text())
    assert sorted(history) == ["accuracy", "examples_per_sec", "loss",
                               "step_time_ms", "val_accuracy", "val_loss"]
    beats = [json.loads((out / "heartbeat-0.json").read_text())
             for out in (jout, tout)]
    assert beats[0]["step"] == beats[1]["step"] == 32  # every 4th of 34


def test_image_mode_matches_the_jax_cli(tmp_path):
    data = str(tmp_path / "imgs")
    make_synthetic_image_dataset(data, num_images=40, height=H, width=W)
    _, tout, history = _run_both(tmp_path, [
        "--data-path", data, "--epochs", "2", "--batch-size", "8",
        "--img-height", str(H), "--img-width", str(W), "--flat-layer",
        "--checkpoint-every-steps", "1"], "cnn-b1")
    assert sorted(history) == ["examples_per_sec", "loss", "mae", "mse",
                               "step_time_ms", "val_loss", "val_mae",
                               "val_mse"]
    assert _notes(tout, "cnn-b1")["final step"] == "8"  # 32 train rows / 8

    # the checker on that run: predict == the model's forward
    checker = image_checker.ManualImageChecker(
        str(tout / "checkpoints"), (H, W), flat=True,
        output_dir=str(tmp_path / "plots"), device="cpu")
    _, saved = CheckpointManager(str(tout / "checkpoints")).read()
    model = CNNRegressor(flat=True, image_size=(H, W), device="cpu")
    model.load_state_dict(saved["params"])
    paths, targets = list_labeled_images(data)
    errors = []
    for path, target in zip(paths, targets):
        image = load_image(path, H, W)
        with torch.no_grad():
            want = model(torch.from_numpy(image[None]))[0].numpy()
        got = checker.predict(image)
        assert got == (float(want[0]), float(want[1]))
        errors.append(np.hypot(got[0] - target[0], got[1] - target[1]))
    result = checker.main(data, plots=False)
    assert result == {"n_images": 40,
                      "mean_px_error": float(np.mean(errors)),
                      "max_px_error": float(np.max(errors)),
                      "plots_dir": None}
    assert not (tmp_path / "plots").exists()
    plotted = image_checker.cli([
        "--checkpoint-dir", str(tout / "checkpoints"), "--data-dir", data,
        "--img-height", str(H), "--img-width", str(W), "--flat-layer",
        "--output-dir", str(tmp_path / "plots"), "--device", "cpu"])
    assert plotted["mean_px_error"] == result["mean_px_error"]
    assert len(list((tmp_path / "plots").glob("*_eval.png"))) == 40


def test_refusals(tmp_path):
    csv = str(tmp_path / "d.csv")
    make_synthetic_csv(csv, rows=120)
    data = str(tmp_path / "imgs")
    make_synthetic_image_dataset(data, num_images=10, height=16, width=16)
    base = ["--output-dir", str(tmp_path / "out"), "--device", "cpu"]
    for main in (jcli.main, cli.main):
        extra = base if main is cli.main else base[:2]
        with pytest.raises(ValueError, match="CSV mode trains the MLP"):
            main(["--data-path", csv, "--model", "resnet50"] + extra)
        with pytest.raises(ValueError, match="Image mode trains the CNN"):
            main(["--data-path", data, "--model", "mlp", "--img-height",
                  "16", "--img-width", "16", "--batch-size", "8"] + extra)
        with pytest.raises(SystemExit):
            main(["--data-path", csv, "--model", "vit"] + extra)
    # the axes of the next slice raise, naming it
    for flags in (["--mesh-shape", "pp=2"], ["--mesh-shape", "dp=1,ep=2"],
                  ["--mesh-shape", "sp=2"], ["--dcn-mesh-shape", "pp=2"]):
        with pytest.raises(NotImplementedError, match="P11b"):
            cli.main(["--data-path", csv] + base + flags)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--data-path", csv, "--output-dir",
                      str(tmp_path / "out")])
    # a one-device mesh trains (a world of one rank)
    try:
        history = cli.main(["--data-path", csv, "--mesh-shape", "dp=1",
                            "--batch-size", "16"] + base)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert len(history["loss"]) == 1


def test_profile_dir_writes_a_trace(tmp_path):
    csv = str(tmp_path / "d.csv")
    make_synthetic_csv(csv, rows=120)
    cli.main(["--data-path", csv, "--batch-size", "16", "--device", "cpu",
              "--output-dir", str(tmp_path / "out"),
              "--profile-dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_config_matches_the_jax_flags():
    jfields = {f.name: f.default for f in dataclasses.fields(jconfig.Config)}
    tfields = {f.name: f.default for f in dataclasses.fields(config.Config)}
    assert set(tfields) == set(jfields) | {"device"}
    assert all(tfields[k] == jfields[k] for k in tfields if k != "device")
    assert tfields["device"] == os.environ.get("DEVICE", "cuda")
    argv = ["--data-path", "x.csv", "--epochs", "3", "--batch-size", "8",
            "--flat-layer", "--lr-schedule", "cosine", "--optimizer", "adamw",
            "--weight-decay", "0.1", "--grad-accum-steps", "2",
            "--compute-dtype", "float32", "--checkpoint-every-steps", "5",
            "--resume", "--max-restarts", "2", "--fail-at-steps", "3,9",
            "--heartbeat-file", "/tmp/hb.json", "--mesh-shape", "dp=1"]
    j, t = jconfig.parse_args(argv), config.parse_args(argv + [
        "--device", "cpu"])
    for name in tfields:
        if name != "device":
            assert getattr(t, name) == getattr(j, name), name
    assert t.device == "cpu" and t.mesh_axes() == {"dp": 1}
    assert config.parse_mesh_shape(" dp=4, ,tp=2") == jconfig.parse_mesh_shape(
        " dp=4, ,tp=2") == {"dp": 4, "tp": 2}
    assert json.loads(t.to_json())["device"] == "cpu"
