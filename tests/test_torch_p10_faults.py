"""PyTorch port, two faults of earlier slices against the JAX package:

* ``Trainer(mu_dtype=torch.bfloat16)`` / ``make_optimizer(mu_dtype=)``
  against ``optax.adam(lr, mu_dtype=jnp.bfloat16)`` (optax 0.2.6, the
  JAX trainer's optimizer) over five updates of a flax-shaped tree: the
  parameters within 1e-6 relative to each element and to its leaf's
  largest value (the f32 formulas of ``test_torch_optimizers.py``), the
  stored first moment bf16 and equal to optax's; ``tx``
  given wins over ``mu_dtype``; a checkpoint round trip keeps the
  moment's dtype and values.
* The reference-parity CLI's initial parameters: ``train.cli`` builds
  the MLP, CNN-B1 and CNN-A1 (at 32x40) with exactly the parameters the
  JAX CLI's ``init(jax.random.key(--seed), x)`` gives, at seeds 0 and
  1337; and from them an f32 MLP run's history equals the JAX CLI's
  within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyspark_tf_gke_tpu.models import build_model as jbuild
from pyspark_tf_gke_tpu.train import cli as jcli
from pyspark_tf_gke_tpu_torch.data.synthetic import (
    make_synthetic_csv, make_synthetic_image_dataset)
from pyspark_tf_gke_tpu_torch.models.layers import (flatten_flax,
                                                    flax_parameters)
from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier
from pyspark_tf_gke_tpu_torch.train import cli
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

torch.set_num_threads(1)

RTOL = 1e-6
SHAPES = {"dense/kernel": (160, 130), "dense/bias": (130,),
          "conv/kernel": (3, 3, 8, 16), "ln/scale": (24,)}
H, W = 32, 40


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_mu_dtype_bfloat16_matches_optax():
    rng = np.random.default_rng(3)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]
    jtx = optax.adam(1e-2, mu_dtype=jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, _tree(params))
    jstate = jtx.init(jparams)
    tx = make_optimizer(1e-2, mu_dtype=torch.bfloat16)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, _tree(g)),
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tx.update({k: torch.tensor(v) for k, v in g.items()}, tstate,
                  tparams)
    want = _leaves(jparams)
    for k, v in tparams.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(
            v.numpy(), want[k], rtol=RTOL,
            atol=RTOL * float(np.abs(want[k]).max()), err_msg=k)
    jmu = _leaves(jstate[0].mu)
    for k, mu in tstate["mu"].items():
        assert mu.dtype == torch.bfloat16 and jmu[k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(mu.float().numpy(),
                                      jmu[k].astype(np.float32), err_msg=k)
        assert tstate["nu"][k].dtype == torch.float32


def test_trainer_mu_dtype_and_checkpoint_round_trip(tmp_path):
    def trainer(**kw):
        model = MLPClassifier(4, 3, device="cpu", seed=2)
        return Trainer(model, TASKS["classification"](), learning_rate=1e-3,
                       **kw)

    t = trainer(mu_dtype=torch.bfloat16)
    state = t.init_state()
    assert {m.dtype for m in state.opt_state["mu"].values()} == {
        torch.bfloat16}
    assert {n.dtype for n in state.opt_state["nu"].values()} == {
        torch.float32}
    # tx given: mu_dtype is ignored, as in the JAX trainer
    given = trainer(tx=make_optimizer(1e-3), mu_dtype=torch.bfloat16)
    assert {m.dtype for m in given.init_state().opt_state["mu"].values()} \
        == {torch.float32}
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.normal(size=(8, 3)).astype(
        np.float32)), "y": torch.from_numpy(rng.integers(0, 4, 8))}
    for _ in range(3):
        state, _ = t.step(state, batch)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(state)
    ckpt.wait()
    fresh = trainer(mu_dtype=torch.bfloat16)
    restored = ckpt.restore(fresh.init_state())
    ckpt.close()
    assert restored.step == 3
    for k, mu in state.opt_state["mu"].items():
        got = restored.opt_state["mu"][k]
        assert got.dtype == torch.bfloat16 and torch.equal(got, mu)


def _captured_init(monkeypatch, argv):
    """The parameters ``train.cli`` builds its model with (before any
    step), from a one-step run."""
    seen = {}
    build = cli.build_model

    def capture(*args, **kwargs):
        model = build(*args, **kwargs)
        seen.update({k: p.detach().clone()
                     for k, p in flax_parameters(model).items()})
        return model

    monkeypatch.setattr(cli, "build_model", capture)
    cli.main(argv + ["--device", "cpu", "--epochs", "1",
                     "--steps-per-epoch", "1"])
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("seed", [0, 1337])
@pytest.mark.parametrize("mode", ["mlp", "cnn-b1", "cnn-a1"])
def test_cli_starts_from_the_jax_clis_parameters(tmp_path, monkeypatch,
                                                 seed, mode):
    common = ["--seed", str(seed), "--batch-size", "8", "--output-dir",
              str(tmp_path / "out")]
    if mode == "mlp":
        data = str(tmp_path / "d.csv")
        make_synthetic_csv(data, rows=60)
        got = _captured_init(monkeypatch, ["--data-path", data] + common)
        jmodel = jbuild("mlp", num_classes=got["Dense_3/kernel"].shape[1])
        x = np.zeros((1, 3), np.float32)
    else:
        data = str(tmp_path / "imgs")
        make_synthetic_image_dataset(data, num_images=10, height=H, width=W)
        flat = mode == "cnn-b1"
        got = _captured_init(monkeypatch, [
            "--data-path", data, "--img-height", str(H), "--img-width",
            str(W)] + (["--flat-layer"] if flat else []) + common)
        jmodel = jbuild("cnn", flat=flat)
        x = np.zeros((1, H, W, 3), np.float32)
    want = flatten_flax(jax.device_get(jax.jit(jmodel.init)(
        jax.random.key(seed), x)["params"]))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), (seed, mode, k)


def test_mlp_cli_history_equals_the_jax_clis(tmp_path):
    data = str(tmp_path / "d.csv")
    make_synthetic_csv(data, rows=200)
    args = ["--data-path", data, "--epochs", "2", "--batch-size", "16",
            "--seed", "0", "--heartbeat-every-steps", "0"]
    want = jcli.main(args + ["--output-dir", str(tmp_path / "jax")])
    got = cli.main(args + ["--output-dir", str(tmp_path / "port"),
                           "--device", "cpu"])
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
