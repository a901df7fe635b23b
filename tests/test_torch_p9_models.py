"""PyTorch port, the reference-parity models against the JAX package on
carried weights: the MLP, CNN-B1 and CNN-A1 at 32x40 (forward and every
gradient; f32 within 1e-5 relative, bf16 within 2e-2 of the output's
scale and 5e-2 relative L2 on the gradients), PReLU with shared axes,
B1's 43,368,850 parameters at 256x320 counted on the meta device, the
Keras initialisers' law, ``utils/seeding.jax_init_params`` bit for bit
against flax's init, Adam's ``eps``, ``build_model`` and a few ``Trainer``
steps (f32, Adam eps 1e-7) against the JAX ``Trainer`` with
``optax.adam(eps=1e-7)``: metrics within 1e-5 relative, weights within
1% of the most Adam's steps can move them (lr a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from pyspark_tf_gke_tpu.models import CNNRegressor as JCNN
from pyspark_tf_gke_tpu.models import MLPClassifier as JMLP
from pyspark_tf_gke_tpu.models import PReLU as JPReLU
from pyspark_tf_gke_tpu.models import build_model as jbuild
from pyspark_tf_gke_tpu.parallel.mesh import make_mesh
from pyspark_tf_gke_tpu.train.trainer import TASKS as JTASKS
from pyspark_tf_gke_tpu.train.trainer import Trainer as JTrainer
from pyspark_tf_gke_tpu_torch.models import build_model
from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor, PReLU
from pyspark_tf_gke_tpu_torch.models.layers import (flatten_flax,
                                                    flax_parameters)
from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier
from pyspark_tf_gke_tpu_torch.models.resnet import ResNet
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer
from pyspark_tf_gke_tpu_torch.utils import seeding

torch.set_num_threads(1)

H, W = 32, 40


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))


def _jax_grads(model, params, x, g):
    """d/d(params, x) of sum(model(x) * g) in JAX."""
    def f(p, xx):
        return jnp.sum(model.apply({"params": p}, xx) * g)

    return jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)


def _torch_grads(model, x, g):
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    out = model(xt)
    (out * torch.from_numpy(g)).sum().backward()
    grads = {k: p.grad.numpy() for k, p in flax_parameters(model).items()}
    return out.detach().numpy(), grads, xt.grad.numpy()


def _compare(jmodel, tmodel, x, tol_out, tol_grad):
    params = jax.jit(jmodel.init)(jax.random.key(3), x)["params"]
    tmodel.load_params(jax.device_get(params))
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x))
    g = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    jg, jgx = _jax_grads(jmodel, params, x, g)
    got, tg, tgx = _torch_grads(tmodel, x, g)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= tol_out * np.abs(want).max()
    jflat = {k: v.numpy() for k, v in flatten_flax(jax.device_get(jg)).items()}
    assert jflat.keys() == tg.keys()
    for k in jflat:
        assert _rel(tg[k], jflat[k]) < tol_grad, k
    assert _rel(tgx, jgx) < tol_grad


def test_mlp_forward_and_gradients_match():
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    _compare(JMLP(num_classes=6), MLPClassifier(6, 3, device="cpu"), x,
             1e-5, 1e-5)


@pytest.mark.parametrize("flat", [True, False])
def test_cnn_f32_forward_and_gradients_match(flat):
    x = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    _compare(JCNN(flat=flat), CNNRegressor(flat=flat, image_size=(H, W),
                                           device="cpu"), x, 1e-5, 1e-5)


@pytest.mark.parametrize("flat", [True, False])
def test_cnn_bf16_forward_and_gradients_match(flat):
    """bf16 compute over f32 parameters: XLA's CPU fusion keeps some f32
    intermediates that PyTorch rounds to bf16, so the outputs agree to
    2e-2 of their scale and the gradients to 5e-2 relative L2."""
    x = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    _compare(JCNN(flat=flat, dtype=jnp.bfloat16),
             CNNRegressor(flat=flat, dtype=torch.bfloat16, image_size=(H, W),
                          device="cpu"), x, 2e-2, 5e-2)


def test_prelu_shared_axes_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    for shared in (None, (1, 2), (3,)):
        jm = JPReLU(shared_axes=shared)
        params = jm.init(jax.random.key(0), x)["params"]
        alpha = rng.uniform(0.1, 0.5, params["alpha"].shape).astype(
            np.float32)
        tm = PReLU((4, 5, 3), shared)
        assert tuple(tm.alpha.shape) == alpha.shape
        with torch.no_grad():
            tm.alpha.copy_(torch.from_numpy(alpha))
        g = rng.standard_normal(x.shape).astype(np.float32)

        def f(a, xx):
            return jnp.sum(jm.apply({"params": {"alpha": a}}, xx) * g)

        want = np.asarray(jax.jit(jm.apply)({"params": {"alpha": alpha}}, x))
        ja, jx = jax.jit(jax.grad(f, argnums=(0, 1)))(alpha, x)
        xt = torch.from_numpy(x).requires_grad_(True)
        out = tm(xt)
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(tm.alpha.grad.numpy(), ja, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), jx, rtol=1e-6)
    # the model's alphas take the shared shape too
    shapes = {k: tuple(p.shape) for k, p in CNNRegressor(
        prelu_shared_axes=(1, 2), image_size=(H, W),
        device="meta").named_parameters()}
    jshapes = {k.replace("/", "."): tuple(v.shape)
               for k, v in flatten_flax_shapes(jax.eval_shape(
                   lambda: JCNN(prelu_shared_axes=(1, 2)).init(
                       jax.random.key(0), jnp.zeros((1, H, W, 3))))[
                   "params"]).items()}
    assert shapes == jshapes and shapes["PReLU_2.alpha"] == (1, 1, 32)


def test_b1_parameter_count_at_the_reference_size():
    port = CNNRegressor(flat=True, image_size=(256, 320), device="meta")
    count = sum(p.numel() for p in port.parameters())
    assert all(p.device.type == "meta" for p in port.parameters())
    abstract = jax.eval_shape(lambda: JCNN(flat=True).init(
        jax.random.key(0), jnp.zeros((1, 256, 320, 3))))["params"]
    jcount = sum(int(np.prod(v.shape))
                 for v in jax.tree_util.tree_leaves(abstract))
    assert count == jcount == 43_368_850
    shapes = {k: tuple(p.shape) for k, p in flax_parameters(port).items()}
    assert shapes["Dense_0/kernel"] == (20480, 2048)
    assert shapes["PReLU_0/alpha"] == (256, 320, 8)
    assert shapes["PReLU_4/alpha"] == (16, 20, 64)
    odd = CNNRegressor(flat=True, image_size=(33, 41), device="meta")
    jodd = jax.eval_shape(lambda: JCNN(flat=True).init(
        jax.random.key(0), jnp.zeros((1, 33, 41, 3))))["params"]
    assert {k: tuple(p.shape) for k, p in flax_parameters(odd).items()} == {
        k: tuple(v.shape) for k, v in flatten_flax_shapes(jodd).items()}


def flatten_flax_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten_flax_shapes(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def test_keras_initialiser_law():
    """Glorot-uniform kernels within ``sqrt(6 / (fan_in + fan_out))``
    with flax's conv fans, a uniform's spread, biases and alphas 0."""
    for model in (CNNRegressor(flat=True, image_size=(H, W), device="cpu",
                               seed=4), MLPClassifier(6, 3, device="cpu")):
        for path, p in flax_parameters(model).items():
            t = p.detach().numpy()
            if not path.endswith("kernel"):
                assert not t.any(), path
                continue
            rf = int(np.prod(t.shape[:-2]))
            limit = np.sqrt(6.0 / (rf * t.shape[-2] + rf * t.shape[-1]))
            assert np.abs(t).max() <= limit, path
            if t.size >= 10_000:
                assert abs(t.std() / (limit / np.sqrt(3)) - 1) < 0.03, path
                assert np.abs(t).max() > 0.99 * limit, path
    a = MLPClassifier(6, 3, device="cpu", seed=1).Dense_0.kernel
    b = MLPClassifier(6, 3, device="cpu", seed=1).Dense_0.kernel
    c = MLPClassifier(6, 3, device="cpu", seed=2).Dense_0.kernel
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_chip_smoke_replays_the_jax_init_bit_for_bit():
    for jm, tm, x in (
            (JMLP(num_classes=6), MLPClassifier(6, 3, device="meta"),
             np.zeros((1, 3), np.float32)),
            (JCNN(flat=True), CNNRegressor(flat=True, image_size=(H, W),
                                           device="meta"),
             np.zeros((1, H, W, 3), np.float32))):
        for seed in (1337, 5):
            want = flatten_flax(jax.device_get(
                jax.jit(jm.init)(jax.random.key(seed), x)["params"]))
            got = seeding.jax_init_params(tm, seed)
            assert want.keys() == got.keys()
            for k in want:
                assert torch.equal(want[k], got[k]), (seed, k)
    # a kernel drawn in many chunks, in parallel, is the one drawn whole
    key = seeding._flax_key(1337, "Dense_0", 1)
    np.testing.assert_array_equal(
        seeding._glorot_uniform(key, (64, 100), chunk=777),
        seeding._glorot_uniform(key, (64, 100)))


def test_adam_eps_mirrors_optax():
    assert make_optimizer(1e-3).eps == 1e-8
    assert make_optimizer(1e-3, optimizer="lamb").eps == 1e-6
    params = {"w": np.array([[0.5, -0.25], [1.0, 2.0]], np.float32)}
    grads = {"w": np.array([[1e-7, -3e-7], [2e-6, 0.0]], np.float32)}
    tx = optax.adam(1e-3, eps=1e-7)
    upd, _ = tx.update(grads, tx.init(params), params)
    want = np.asarray(optax.apply_updates(params, upd)["w"])
    p = {"w": torch.from_numpy(params["w"].copy())}
    opt = make_optimizer(1e-3, eps=1e-7)
    opt.update({"w": torch.from_numpy(grads["w"])}, opt.init(p), p)
    np.testing.assert_allclose(p["w"].numpy(), want, rtol=1e-7)


def test_build_model_names():
    assert isinstance(build_model("mlp", num_classes=4, input_dim=3,
                                  device="cpu"), MLPClassifier)
    cnn = build_model("cnn", flat=True, image_size=(H, W), device="meta")
    assert isinstance(cnn, CNNRegressor) and cnn.flat
    resnet = build_model("resnet50", device="meta" if False else "cpu",
                         num_filters=8)
    assert isinstance(resnet, ResNet) and resnet.dtype == torch.float32
    for name in ("vit", "moe"):
        with pytest.raises(ValueError, match=f"Unknown model '{name}'"):
            build_model(name)
        with pytest.raises(ValueError, match=f"Unknown model '{name}'"):
            jbuild(name)


def _trainer_pair(jmodel, tmodel, task, sample):
    mesh = make_mesh({"dp": 1}, jax.devices()[:1])
    jt = JTrainer(jmodel, JTASKS[task](), mesh,
                  tx=optax.adam(1e-3, eps=1e-7))
    jstate = jt.init_state(jax.random.key(1337), sample)
    tmodel.load_params(jax.device_get(jstate.params))
    tt = Trainer(tmodel, TASKS[task](), tx=make_optimizer(1e-3, eps=1e-7))
    return jt, jstate, tt, tt.init_state()


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_trainer_steps_match_the_jax_trainer(task):
    if task == "classification":
        x, y = chip_smoke.make_health_arrays(64)
        batches = [{"x": x[i:i + 16], "y": y[i:i + 16]}
                   for i in range(0, 64, 16)]
        jm, tm = JMLP(num_classes=6), MLPClassifier(6, 3, device="cpu")
    else:
        images, targets = chip_smoke.make_spot_arrays(12, H, W, seed=3)
        batches = [{"image": images[i:i + 4], "target": targets[i:i + 4]}
                   for i in range(0, 12, 4)]
        jm = JCNN(flat=True)
        tm = CNNRegressor(flat=True, image_size=(H, W), device="cpu")
    jt, js, tt, ts = _trainer_pair(jm, tm, task, batches[0])
    for step, batch in enumerate(batches + batches):
        js, jmetrics = jt.step(js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        ts, tmetrics = tt.step(ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert jmetrics.keys() == tmetrics.keys()
        for k in jmetrics:
            want, got = float(jmetrics[k]), float(tmetrics[k])
            assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3), (step, k)
    assert ts.step == int(js.step) == 2 * len(batches)
    # Adam moves a weight by at most lr a step whatever its gradient's
    # size, so rounding in a near-zero gradient can move it by that much:
    # the weights agree to 1% of the most the steps could move them
    want = flatten_flax(jax.device_get(js.params))
    got = flax_parameters(tm)
    for k in want:
        diff = float((got[k].detach() - want[k]).abs().max())
        assert diff <= 1e-2 * 1e-3 * ts.step, k
