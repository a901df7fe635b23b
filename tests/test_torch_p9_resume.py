"""PyTorch port, the training CLI's fault injection, restart and resume,
gradient accumulation and the stall watchdog, against itself and the JAX
package on the CPU:

* ``--fail-at-steps`` with ``--max-restarts 1`` ends with the history
  and the weights of a run that stopped cleanly at the same save and
  was resumed with ``--resume`` (the JAX CLI's restart, like its resume,
  runs ``--epochs`` from the restored step), exactly, with the restore at
  an epoch boundary and inside a pass over the data; the JAX CLI with
  the same flags restarts at the same step and ends at the same one;
* ``--grad-accum-steps 2`` at batch 8 takes the steps of batch 16 (same
  rows in the same order: losses within 1e-5), and the JAX CLI's counts;
* ``detect_stall`` and ``python -m pyspark_tf_gke_tpu_torch.train.
  resilience`` exit as the JAX watchdog does on the same heartbeat files.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.obs import events as jevents
from pyspark_tf_gke_tpu.train import cli as jcli
from pyspark_tf_gke_tpu.train import resilience as jres
from pyspark_tf_gke_tpu_torch.data.csv_loader import load_csv
from pyspark_tf_gke_tpu_torch.data.pipeline import train_validation_split
from pyspark_tf_gke_tpu_torch.data.synthetic import make_synthetic_csv
from pyspark_tf_gke_tpu_torch.obs import events as tevents
from pyspark_tf_gke_tpu_torch.train import cli
from pyspark_tf_gke_tpu_torch.train import resilience as tres
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.train.resilience import InjectedFault

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMING = ("step_time_ms", "examples_per_sec")


def _csv(tmp_path) -> str:
    """A synthetic CSV whose training split (80%) is a multiple of 16
    rows, so batches of 8 pair up into the batches of 16."""
    for rows in range(400, 480):
        path = str(tmp_path / f"d{rows}.csv")
        make_synthetic_csv(path, rows=rows)
        n = len(load_csv(path)[1])
        if len(train_validation_split(n, 0.2)[0]) % 16 == 0:
            return path
    raise AssertionError("no row count gives a split of 16s")


def _with_trail(module, path, fn):
    module.set_event_log(module.EventLog(str(path)))
    try:
        return fn(), list(module.read_events(str(path)))
    finally:
        module.set_event_log(None)


def _starts(events):
    return [e["start_step"] for e in events if e["kind"] == "train_fit_start"]


def _untimed(history):
    return {k: v for k, v in history.items() if k not in TIMING}


def _final_params(out: Path):
    step, saved = CheckpointManager(str(out / "checkpoints")).read()
    return step, saved["params"]


@pytest.mark.parametrize("steps_per_epoch", [0, 7])
def test_fault_and_restart_equals_a_clean_resume(tmp_path, steps_per_epoch):
    csv = _csv(tmp_path)
    spe = steps_per_epoch or len(train_validation_split(
        len(load_csv(csv)[1]), 0.2)[0]) // 16
    flags = ["--data-path", csv, "--batch-size", "16",
             "--checkpoint-every-steps", "1", "--steps-per-epoch",
             str(steps_per_epoch), "--heartbeat-every-steps", "0"]
    port = flags + ["--device", "cpu"]
    fault = ["--epochs", "2", "--fail-at-steps", str(spe + spe // 2 + 1),
             "--max-restarts", "1"]
    # the faulted run: a save at spe, the fault in epoch 2, a restart
    faulted, trail = _with_trail(tevents, tmp_path / "t.jsonl", lambda: (
        cli.main(port + fault + ["--output-dir", str(tmp_path / "f")])))
    assert _starts(trail) == [0, spe]
    kinds = [e["kind"] for e in trail]
    assert kinds.count("fault_injected") == 1
    assert "recovery_succeeded" in kinds and "retry" in kinds
    # a clean stop at the same save, then --resume
    cli.main(port + ["--epochs", "1", "--output-dir", str(tmp_path / "c")])
    resumed = cli.main(port + ["--epochs", "2", "--resume", "--output-dir",
                               str(tmp_path / "c")])
    assert _untimed(faulted) == _untimed(resumed)
    assert len(faulted["loss"]) == 2 and np.isfinite(faulted["loss"]).all()
    step_f, params_f = _final_params(tmp_path / "f")
    step_c, params_c = _final_params(tmp_path / "c")
    assert step_f == step_c == 3 * spe
    assert params_f.keys() == params_c.keys()
    assert all(torch.equal(params_f[k], params_c[k]) for k in params_f)
    # the JAX CLI replays the same steps
    jhist, jtrail = _with_trail(jevents, tmp_path / "j.jsonl", lambda: (
        jcli.main(flags + fault + ["--output-dir", str(tmp_path / "j")])))
    assert _starts(jtrail) == _starts(trail)
    assert [e["kind"] for e in jtrail].count("fault_injected") == 1
    assert len(jhist["loss"]) == len(faulted["loss"])
    jsteps = sorted(int(p.name) for p in (tmp_path / "j" / "checkpoints")
                    .iterdir() if p.name.isdigit())
    tsteps = sorted(int(p.name) for p in (tmp_path / "f" / "checkpoints")
                    .iterdir() if p.name.isdigit())
    assert jsteps == tsteps and tsteps[-1] == 3 * spe


def test_exhausted_restarts_raise(tmp_path):
    csv = _csv(tmp_path)
    with pytest.raises(InjectedFault):
        cli.main(["--data-path", csv, "--batch-size", "16", "--device",
                  "cpu", "--output-dir", str(tmp_path / "o"),
                  "--fail-at-steps", "3"])


def test_grad_accum_takes_the_steps_of_the_larger_batch(tmp_path):
    csv = _csv(tmp_path)
    base = ["--data-path", csv, "--epochs", "2", "--device", "cpu",
            "--heartbeat-every-steps", "0"]
    big = cli.main(base + ["--batch-size", "16", "--output-dir",
                           str(tmp_path / "big")])
    accum = cli.main(base + ["--batch-size", "8", "--grad-accum-steps", "2",
                             "--output-dir", str(tmp_path / "acc")])
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(accum[k], big[k], rtol=1e-5)
    step_b, params_b = _final_params(tmp_path / "big")
    step_a, params_a = _final_params(tmp_path / "acc")
    assert step_a == step_b
    for k in params_b:
        assert float((params_a[k] - params_b[k]).abs().max()) <= 1e-2 * (
            1e-3 * step_b), k
    # ceil(steps / accum): an odd pass rounds up, as in the JAX CLI
    flags = ["--data-path", csv, "--epochs", "1", "--batch-size", "8",
             "--grad-accum-steps", "3", "--heartbeat-every-steps", "0"]
    jhist = jcli.main(flags + ["--output-dir", str(tmp_path / "j3")])
    thist = cli.main(flags + ["--device", "cpu", "--output-dir",
                              str(tmp_path / "t3")])
    jnotes = (tmp_path / "j3" / "mlp.txt").read_text()
    tnotes = (tmp_path / "t3" / "mlp.txt").read_text()
    final = [line for line in tnotes.splitlines()
             if line.startswith("final step")]
    assert final and final[0] in jnotes.splitlines()
    assert sorted(jhist) == sorted(thist)


def _beat(path: Path, step: int, at: float) -> Path:
    path.write_text(json.dumps({"step": step, "time": at, "process_index": 0,
                                "process_count": 1}))
    return path


def test_watchdog_exit_codes_match(tmp_path, capsys):
    stale = _beat(tmp_path / "stale.json", 3, 1.0)
    fresh = _beat(tmp_path / "fresh.json", 9, time.time() + 3600)
    missing = tmp_path / "missing.json"
    cases = (
        (["--paths", str(stale), "--stall", "5", "--timeout", "2",
          "--poll", "0.05"], 1),
        (["--paths", str(fresh), "--stall", "60", "--timeout", "0.3",
          "--poll", "0.05"], 0),
        (["--paths", f"{fresh},{stale}", "--stall", "60", "--timeout", "2",
          "--poll", "0.05"], 1),
        (["--paths", str(missing), "--stall", "0.1", "--timeout", "2",
          "--poll", "0.05"], 1),
        (["--paths", str(missing), "--stall", "60", "--timeout", "0.3",
          "--poll", "0.05"], 0),
        (["--paths", str(missing), "--stall", "60", "--timeout", "2",
          "--poll", "0.05", "--startup-grace", "0.1"], 1),
    )
    for argv, rc in cases:
        assert jres._watch_main(argv) == rc, argv
        jout = capsys.readouterr().out
        assert tres._watch_main(argv) == rc, argv
        tout = capsys.readouterr().out
        if rc:
            j, t = json.loads(jout), json.loads(tout)
            assert j["stalled"] == t["stalled"] and j["last"] == t["last"]
        else:
            assert jout == tout == ""
    assert tres.detect_stall([str(missing)], 0.1, 2.0, 0.05) == str(missing)
    assert tres.detect_stall([str(missing)], 60, 0.3, 0.05) is None
    res = subprocess.run(
        [sys.executable, "-m", "pyspark_tf_gke_tpu_torch.train.resilience",
         "--paths", str(stale), "--stall", "5", "--timeout", "2", "--poll",
         "0.05"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    assert json.loads(res.stdout.splitlines()[-1])["last"]["step"] == 3
