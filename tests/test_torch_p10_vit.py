"""PyTorch port, the ViT classifier (``models/vit.py``) and the ``vit``
task against the JAX package on the CPU, at a tiny width (hidden 32, 2
layers, 4 heads, patch 8).

* The patch count, the positions' shape and the "divisible" error; an
  image of another size than the model was built for raises.
* Logits and every gradient from the JAX model's parameters: f32 within
  1e-5 relative to each tensor's scale (two layers of products summed in
  another order; 1e-7 absolute at the least, for the key biases' zero
  gradients); bf16 logits within 3e-2 of their scale and gradients
  within 5e-2 relative L2 (bf16 rounds every product's inputs, at
  points XLA and PyTorch place alike but fuse differently).
* The JAX model on ``use_flash=True`` (the Pallas kernel in interpret
  mode) against the port's flash plain version (``use_flash=True`` on a
  CPU tensor), at S = 17, a length no flash block divides.
* Five ``Trainer`` steps of ``TASKS["vit"]`` against the JAX
  ``Trainer``'s from the same parameters: the metrics within 1e-5.
* ViT with MoE: the aux loss reaches the task's loss and metrics, and
  equals the JAX model's.
* ViT-Base/16 at 224^2 with 1000 classes: 86,569,192 parameters on the
  meta device, as the JAX model's ``init`` counts them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import BertConfig as JaxBertConfig
from pyspark_tf_gke_tpu.models import ViTClassifier as JaxViT
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
from pyspark_tf_gke_tpu_torch.models.layers import flax_parameters
from pyspark_tf_gke_tpu_torch.models.vit import (ViTClassifier, init_params,
                                                 vit_params_from_flax)
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

torch.set_num_threads(1)

TINY = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=8)
P = 8


def _images(b, h, w, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (b, h, w, 3)).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax(cfg_kw, x, num_classes=5, seed=1, dtype=jnp.float32):
    model = JaxViT(JaxBertConfig(**cfg_kw, dtype=dtype),
                   num_classes=num_classes, patch_size=P)
    params = jax.device_get(nn.meta.unbox(model.init(
        jax.random.key(seed), jnp.asarray(x))["params"]))
    return model, params


def _port(cfg_kw, params, image_size, num_classes=5, dtype=torch.float32):
    model = ViTClassifier(BertConfig(**cfg_kw, dtype=dtype), num_classes,
                          patch_size=P, image_size=image_size, device="cpu")
    return model.load_params(vit_params_from_flax(params))


def test_patch_count_and_divisible_error():
    model = ViTClassifier(BertConfig(**TINY, dtype=torch.float32), 5,
                          patch_size=P, image_size=(32, 48), device="cpu")
    assert tuple(model.pos_embedding.shape) == (1, 25, 32)  # 4x6 + CLS
    preds = model(torch.zeros(2, 32, 48, 3))
    assert preds["logits"].shape == (2, 5)
    assert preds["logits"].dtype == torch.float32
    assert preds["aux_loss"].shape == () and float(preds["aux_loss"]) == 0.0
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 30, 48, 3))
    with pytest.raises(ValueError, match="divisible"):
        ViTClassifier(BertConfig(**TINY), 5, patch_size=P,
                      image_size=(30, 48), device="cpu")
    with pytest.raises(ValueError, match="32x48"):
        model(torch.zeros(1, 16, 48, 3))


def _grads_both(jmodel, params, model, x, labels):
    jtask = jtrainer.TASKS["vit"]()
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}

    def jloss(p):
        preds, _ = jtask.forward(jmodel, {"params": p}, batch, True, False)
        return jtask.loss_and_metrics(preds, batch)[0], preds

    (jl, jpreds), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    ttask = ttrainer.TASKS["vit"]()
    tbatch = {"image": torch.from_numpy(x),
              "label": torch.from_numpy(labels)}
    preds = ttask.forward(model, tbatch)
    loss, _ = ttask.loss_and_metrics(preds, tbatch)
    loss.backward()
    got = {k: p.grad for k, p in flax_parameters(model).items()}
    return (float(loss), preds, got), (float(jl), jpreds,
                                       _flat(jax.device_get(jgrads)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_gradients_match_jax(dtype):
    x = _images(3, 32, 40)
    labels = np.array([0, 3, 4], np.int32)
    jmodel, params = _jax(TINY, x, dtype=getattr(jnp, dtype))
    model = _port(TINY, params, (32, 40), dtype=getattr(torch, dtype))
    assert set(model.flax_parameters()) == set(_flat(params))
    (loss, preds, grads), (jl, jpreds, jgrads) = _grads_both(
        jmodel, params, model, x, labels)
    want = np.asarray(jpreds["logits"])
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(preds["logits"].detach().numpy(), want,
                                   atol=1e-5 * scale)
        assert loss == pytest.approx(jl, rel=1e-5)
        for path, g in grads.items():
            w = np.asarray(jgrads[path])
            # a key bias's gradient is 0 up to rounding (softmax ignores
            # it): 1e-7 absolute at the least
            np.testing.assert_allclose(
                g.numpy(), w, atol=max(1e-5 * np.abs(w).max(), 1e-7),
                err_msg=path)
        return
    np.testing.assert_allclose(preds["logits"].detach().numpy(), want,
                               atol=3e-2 * scale)
    num = sum(float(((g - torch.from_numpy(np.asarray(jgrads[p]))) ** 2)
                    .sum()) for p, g in grads.items())
    den = sum(float((np.asarray(jgrads[p]) ** 2).sum()) for p in grads)
    assert (num / den) ** 0.5 < 5e-2


def test_flash_path_matches_the_jax_pallas_kernel():
    """S = 4 x 4 patches + CLS = 17."""
    x = _images(2, 32, 32, seed=2)
    kw = dict(TINY, use_flash=True)
    jmodel, params = _jax(kw, x)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model = _port(kw, params, (32, 32))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_trainer_steps_match_the_jax_trainer(devices):
    from pyspark_tf_gke_tpu.data.pipeline import put_global_batch
    from pyspark_tf_gke_tpu.parallel.mesh import batch_sharding, make_mesh
    from pyspark_tf_gke_tpu.train.harness import (
        make_optimizer as jax_make_optimizer)
    from pyspark_tf_gke_tpu.utils.seeding import make_rng

    rng = np.random.default_rng(4)
    batches = [{"image": _images(4, 16, 24, seed=10 + i),
                "label": rng.integers(0, 3, 4).astype(np.int32)}
               for i in range(5)]
    mesh = make_mesh({"dp": 1}, devices[:1])
    jt = jtrainer.Trainer(
        JaxViT(JaxBertConfig(**TINY, dtype=jnp.float32), num_classes=3,
               patch_size=P), jtrainer.TASKS["vit"](), mesh,
        tx=jax_make_optimizer(1e-3))
    state = jt.init_state(make_rng(0), batches[0])
    model = _port(TINY, jax.device_get(state.params), (16, 24),
                  num_classes=3)
    tt = ttrainer.Trainer(model, ttrainer.TASKS["vit"](),
                          tx=make_optimizer(1e-3))
    tstate = tt.init_state()
    for batch in batches:
        state, jm = jt.step(state, put_global_batch(batch,
                                                    batch_sharding(mesh)))
        tstate, tm = tt.step(tstate, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        jm = jax.device_get(jm)
        assert set(tm) == set(jm) == {"loss", "accuracy", "moe_aux_loss"}
        for key in tm:
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5,
                                                   abs=1e-6), key


def test_vit_moe_aux_loss_reaches_the_task():
    kw = dict(TINY, num_experts=2, moe_every=1)
    x = _images(4, 16, 16, seed=5)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel, params = _jax(kw, x, num_classes=2)
    model = _port(kw, params, (16, 16), num_classes=2)
    assert hasattr(model.layer_0, "moe") and hasattr(model.layer_1, "moe")
    preds = model(torch.from_numpy(x))
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    assert float(preds["aux_loss"]) == pytest.approx(
        float(want["aux_loss"]), rel=1e-5)
    task = ttrainer.TASKS["vit"]()
    loss, metrics = task.loss_and_metrics(preds, {
        "label": torch.from_numpy(labels)})
    aux = float(metrics["moe_aux_loss"])
    assert np.isfinite(aux) and aux > 0
    ce = float(torch.nn.functional.cross_entropy(preds["logits"],
                                                 torch.from_numpy(labels)
                                                 .long()))
    assert float(loss) == pytest.approx(ce + ttrainer.MOE_AUX_WEIGHT * aux,
                                        rel=1e-6)
    loss.backward()
    assert float(model.layer_0.moe.router.grad.norm()) > 0


def test_vit_base_parameter_count():
    model = ViTClassifier(BertConfig(), 1000, device="meta")
    count = sum(p.numel() for p in model.parameters())
    jmodel = JaxViT(JaxBertConfig(), num_classes=1000, patch_size=16)
    abstract = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))["params"]
    jcount = sum(int(np.prod(v.shape))
                 for v in jax.tree_util.tree_leaves(abstract))
    assert count == jcount == 86_569_192
    shapes = {k: tuple(p.shape) for k, p in flax_parameters(model).items()}
    assert shapes["pos_embedding"] == (1, 197, 768)
    assert shapes["patch_embed/kernel"] == (16, 16, 3, 768)


def test_init_params_laws():
    cfg = BertConfig(**TINY, dtype=torch.float32)
    params = init_params(cfg, 5, patch_size=P, image_size=(32, 40), seed=3)
    model = ViTClassifier(cfg, 5, patch_size=P, image_size=(32, 40),
                          device="cpu").load_params(params)
    assert set(params) == set(model.flax_parameters())
    k = params["patch_embed/kernel"].numpy()
    std = np.sqrt(1.0 / (P * P * 3)) / 0.87962566103423978
    assert np.abs(k).max() <= 2 * std
    assert abs(k.std() / (std * 0.87962566103423978) - 1) < 0.1
    for path in ("pos_embedding", "cls_token", "head/kernel"):
        assert abs(float(params[path].std()) - 0.02) < 0.005, path
    assert not params["head/bias"].any()
    assert torch.equal(params["ln_final/scale"], torch.ones(32))
    again = init_params(cfg, 5, patch_size=P, image_size=(32, 40), seed=3)
    assert all(torch.equal(params[p], again[p]) for p in params)
