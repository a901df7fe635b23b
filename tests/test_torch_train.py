"""PyTorch port, the causal-LM training slice on the CPU against the JAX
package: step-0 gradients of the whole model through the causal-LM
task, 3-step loss curves of the trainer under adam and under adamw +
warmup_cosine + clipping (and adam at a head width of 128: hidden 256,
2 heads), ``lm_batches``, and ``lm_pretrain`` end to end
(``--device cpu``, where the kernels' plain versions run).

Both packages start from one JAX init carried over with
``params_from_flax``. Tolerances: f32 gradients within 2e-6 absolute +
2e-4 relative (two layers of f32 products whose sums run in another
order on each side; gradients are O(1e-4..1e-1)); losses within 2e-5 of
each other over 3 steps (the same f32 updates, rounded in another
order; Adam's first step moves every weight by ~lr whatever the size of
its gradient, so tiny gradient differences stay tiny in the loss).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   load_serving_bundle,
                                                   params_from_flax)
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-6, 2e-4
LOSS_ATOL = 2e-5
TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_seq_len=64, dtype=jnp.float32)
# a head width of 128 (a Llama-width head; the bf16 tensor-core flash
# kernels' second width on the card) at a small hidden size
D128 = dict(hidden_size=256, num_heads=2, intermediate_size=256)


def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = jnp.dtype(jcfg.dtype).name
    return config_from_dict(fields)


def _port_model(jcfg, params):
    model = tlm.CausalLM(_port_cfg(jcfg), param_dtype=torch.float32)
    return model.load_params(params_from_flax(params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("case", ["dense", "flash", "gqa", "segments",
                                  "flash_d128"])
def test_step0_gradients_match_jax(case):
    extra = {"dense": {}, "flash": {"use_flash": True},
             "gqa": {"num_kv_heads": 1},
             "segments": {"use_flash": True, "num_kv_heads": 2},
             "flash_d128": {"use_flash": True, **D128}}[case]
    jcfg = jlm.CausalLMConfig(**{**TINY, **extra})
    jmodel = jlm.CausalLM(jcfg)
    rng = np.random.default_rng(30)
    batch = {"input_ids": rng.integers(0, 61, (2, 16)).astype(np.int32)}
    if case == "segments":
        batch["segment_ids"] = np.repeat(np.arange(4), 4)[None].repeat(
            2, 0).astype(np.int32)
    params = nn.meta.unbox(jmodel.init(jax.random.key(1),
                                       jnp.asarray(batch["input_ids"]))
                           ["params"])
    jtask = jtrainer.causal_lm_task()

    def jax_loss(p):
        preds, _ = jtask.forward(jmodel, {"params": p},
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 True, False)
        return jtask.loss_and_metrics(preds, batch)[0]

    jloss, jgrads = jax.value_and_grad(jax_loss)(params)
    jgrads = _flat(jax.device_get(jgrads))

    model = _port_model(jcfg, jax.device_get(params))
    ttask = ttrainer.causal_lm_task()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ttask.loss_and_metrics(ttask.forward(model, tbatch), tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    got = {path: p.grad for path, p in model.flax_parameters().items()}
    assert set(got) == set(jgrads)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[path]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("recipe", ["adam", "adamw_warmup_cosine_clip",
                                    "adamw_warmup_cosine_clip_d128"])
def test_three_step_loss_curve_matches_jax_trainer(recipe, devices):
    """``_d128``: at a head width of 128 (hidden 256, 2 heads) under the
    clipped warmup-cosine recipe. Plain adam at lr 1e-2 there moves each
    of the 15,616 embedding weights by ~lr on its first step whatever its
    gradient, so a weight whose gradient is within Adam's eps of zero
    steps by +-lr on the sign of a rounding residual (one such weight
    read 3.2e-4 apart, the losses within 2e-5)."""
    from pyspark_tf_gke_tpu.data.pipeline import put_global_batch
    from pyspark_tf_gke_tpu.parallel.mesh import batch_sharding, make_mesh
    from pyspark_tf_gke_tpu.train.harness import (
        make_optimizer as jax_make_optimizer)
    from pyspark_tf_gke_tpu.utils.seeding import make_rng

    recipe, _, width = recipe.partition("_d")
    opt = (dict(learning_rate=1e-2) if recipe == "adam" else
           dict(learning_rate=1e-2, optimizer="adamw", weight_decay=0.1,
                schedule="warmup_cosine", warmup_steps=1, total_steps=3,
                grad_clip_norm=0.5))
    mesh = make_mesh({"dp": 1}, devices[:1])
    jcfg = jlm.CausalLMConfig(**{**TINY, **(D128 if width else {})})
    rng = np.random.default_rng(31)
    batches = [{"input_ids": rng.integers(0, 61, (4, 16)).astype(np.int32)}
               for _ in range(3)]
    jt = jtrainer.Trainer(jlm.CausalLM(jcfg, mesh=mesh),
                          jtrainer.TASKS["causal_lm"](), mesh,
                          tx=jax_make_optimizer(**opt))
    state = jt.init_state(make_rng(0), batches[0])
    model = _port_model(jcfg, jax.device_get(state.params))
    tt = ttrainer.Trainer(model, ttrainer.TASKS["causal_lm"](),
                          tx=make_optimizer(**opt))
    tstate = tt.init_state()
    jlosses, tlosses = [], []
    for batch in batches:
        state, m = jt.step(state, put_global_batch(batch,
                                                   batch_sharding(mesh)))
        jlosses.append(float(jax.device_get(m["loss"])))
        tstate, tm = tt.step(tstate, {"input_ids": torch.from_numpy(
            batch["input_ids"])})
        tlosses.append(float(tm["loss"]))
    assert tstate.step == 3
    np.testing.assert_allclose(tlosses, jlosses, atol=LOSS_ATOL)
    if recipe != "adam":
        # warmup_cosine reads lr(0) = 0 for the first update
        assert tlosses[0] == pytest.approx(jlosses[0], abs=1e-6)
    # the parameters after 3 steps agree too
    jparams = _flat(jax.device_get(state.params))
    for path, p in model.flax_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[path],
                                   atol=5e-5, err_msg=path)


def _corpus(tmp_path, n_docs=40, seed=32):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(2):
        text = "\n\n".join(
            "".join(chr(rng.integers(97, 123)) for _ in range(rng.integers(
                20, 200))) for _ in range(n_docs))
        (corpus / f"{i}.txt").write_text(text)
    return corpus


@pytest.mark.parametrize("with_segments", [False, True])
def test_lm_batches_equal_jax(tmp_path, with_segments):
    from pyspark_tf_gke_tpu.data.text import ByteTokenizer as JaxTok
    from pyspark_tf_gke_tpu.data.text import lm_batches as jax_lm_batches
    from pyspark_tf_gke_tpu_torch.data.text import ByteTokenizer, lm_batches

    pattern = str(_corpus(tmp_path) / "*.txt")
    kw = dict(seed=7, shuffle_buffer=16, with_segments=with_segments)
    ours = lm_batches(pattern, ByteTokenizer(), 32, 4, **kw)
    theirs = jax_lm_batches(pattern, JaxTok(), 32, 4, **kw)
    for _ in range(100):  # past one pass over the files: the reseed too
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_lm_pretrain_end_to_end(tmp_path, devices):
    from pyspark_tf_gke_tpu.train.lm_pretrain import main as jax_main
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main

    pattern = str(_corpus(tmp_path) / "*.txt")
    common = ["--data-pattern", pattern, "--seq-len", "32",
              "--hidden-size", "32", "--num-layers", "1", "--num-heads", "2",
              "--intermediate-size", "64", "--epochs", "2",
              "--steps-per-epoch", "2", "--batch-size", "8",
              "--compute-dtype", "float32", "--ema-decay", "0.9",
              "--eval-pattern", pattern, "--eval-batches", "1",
              "--checkpoint-every-steps", "2"]
    jhist = jax_main(common + ["--output-dir", str(tmp_path / "jax")])
    out = tmp_path / "port"
    bundle = tmp_path / "bundle"
    hist = main(common + ["--output-dir", str(out), "--device", "cpu",
                          "--export-bundle", str(bundle)])
    assert set(hist) == set(jhist)
    assert all(len(v) == 2 for v in hist.values())
    assert all(np.isfinite(v).all() for v in hist.values())
    assert json.loads((out / "history.json").read_text()) == hist
    assert (out / "causal-lm.txt").exists()
    ckpts = out / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir() if p.name.isdigit()) == [
        "2", "4"]

    # resume continues the step count from the latest checkpoint
    main(common + ["--output-dir", str(out), "--device", "cpu", "--resume",
                   "--epochs", "1"])
    assert "final step: 6" in (out / "causal-lm.txt").read_text()

    # the exported bundle (EMA weights, int8) loads and generates
    model, params, meta = load_serving_bundle(str(bundle), device="cpu")
    assert meta["tokenizer"] == "byte" and meta["quantized"]
    ids = tlm.generate(model, np.zeros((1, 4), np.int32), max_new_tokens=4)
    assert ids.shape == (1, 8)


def test_lm_pretrain_refuses_unported_flags(tmp_path):
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main

    base = ["--data-pattern", str(tmp_path / "*.txt"), "--device", "cpu"]
    for flags in (["--mesh-shape", "dp=2"], ["--num-processes", "2"],
                  ["--data-format", "tokens"], ["--tokenizer", "gpt2"],
                  ["--vocab-chunks", "4"], ["--async-checkpoint"],
                  ["--optimizer", "lamb"], ["--optimizer", "adafactor"],
                  ["--dcn-mesh-shape", "dp=2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(base + flags)
    with pytest.raises(SystemExit, match="conflicting"):
        main(base + ["--arch", "llama", "--ffn", "gelu"])


# -- optimizer, schedules, state ------------------------------------------------


def _optax_schedule(schedule, lr, total, warmup):
    """The schedules the JAX factory builds (train/harness.py:63-71)."""
    import optax

    if schedule == "constant":
        return lambda count: lr
    if schedule == "cosine":
        return optax.cosine_decay_schedule(lr, total)
    return optax.warmup_cosine_decay_schedule(
        0.0, lr, max(warmup, 1), max(total, warmup + 1))


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("cosine", 0),
                                             ("warmup_cosine", 3)])
def test_schedules_match_optax(schedule, warmup):
    tx = make_optimizer(3e-4, schedule=schedule, total_steps=10,
                        warmup_steps=warmup)
    ref = _optax_schedule(schedule, 3e-4, 10, warmup)
    for count in range(13):
        assert tx.lr(count) == pytest.approx(float(ref(count)), rel=1e-6,
                                             abs=1e-12), count
    if schedule == "warmup_cosine":
        assert tx.lr(0) == 0.0  # the first update is read at count 0


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("opt", ["adam", "adamw", "sgd", "momentum"])
def test_optimizer_updates_match_optax(opt, clip):
    """Three updates of a matrix and a vector: the port's in-place
    multi-tensor update against the optax chain the JAX factory builds
    (f32 on both sides; 1e-6 absolute on O(1) parameters)."""
    import optax

    from pyspark_tf_gke_tpu.train.harness import (
        make_optimizer as jax_make_optimizer)

    kw = dict(learning_rate=0.05, optimizer=opt, grad_clip_norm=clip,
              schedule="cosine", total_steps=5,
              weight_decay=0.1 if opt == "adamw" else 0.0)
    rng = np.random.default_rng(33)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jtx = jax_make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jparams)
    tx = make_optimizer(**kw)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tparams)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate,
                  tparams)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=k)


def _tiny_port(remat=False, seed=5):
    cfg = tlm.CausalLMConfig(vocab_size=61, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_seq_len=64, dtype=torch.float32, remat=remat)
    model = tlm.CausalLM(cfg, param_dtype=torch.float32)
    return model.load_params(tlm.init_params(cfg, seed=seed))


def test_remat_and_grad_accumulation_keep_the_gradients():
    rng = np.random.default_rng(34)
    ids = torch.from_numpy(rng.integers(0, 61, (2, 16)).astype(np.int32))
    batch = {"input_ids": ids}
    task = ttrainer.causal_lm_task()
    grads = []
    for remat in (False, True):
        model = _tiny_port(remat)
        loss, _ = task.loss_and_metrics(task.forward(model, batch), batch)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0)

    # two microbatches of the same rows = one step on them
    one = ttrainer.Trainer(_tiny_port(), task, learning_rate=1e-2)
    two = ttrainer.Trainer(_tiny_port(), task, learning_rate=1e-2)
    s1, s2 = one.init_state(), two.init_state()
    one.step(s1, batch)
    _, metrics = two.accum_step(s2, iter([batch, batch]), 2)
    assert s2.step == 1 and set(metrics) == {"loss", "next_token_accuracy"}
    for n, p in s1.params.items():
        torch.testing.assert_close(s2.params[n], p, rtol=0, atol=1e-7)


def test_ema_checkpoint_roundtrip_and_heartbeat(tmp_path):
    from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
    from pyspark_tf_gke_tpu_torch.train.resilience import Heartbeat

    with pytest.raises(ValueError, match="ema_decay"):
        ttrainer.Trainer(_tiny_port(), ttrainer.causal_lm_task(),
                         ema_decay=1.0).init_state()
    trainer = ttrainer.Trainer(_tiny_port(), ttrainer.causal_lm_task(),
                               learning_rate=1e-2, ema_decay=0.9)
    state = trainer.init_state()
    init = {n: p.detach().clone() for n, p in state.params.items()}
    batch = {"input_ids": torch.from_numpy(np.random.default_rng(35).integers(
        0, 61, (2, 16)).astype(np.int32))}
    ckpt = CheckpointManager(str(tmp_path / "ck"), every_steps=1,
                             max_to_keep=2)
    for _ in range(3):
        trainer.step(state, batch)
        ckpt.maybe_save(state, {"loss": [1.0]})
    assert ckpt.all_steps() == [2, 3]
    assert json.loads((tmp_path / "ck" / "history.json").read_text()) == {
        "loss": [1.0]}
    # the EMA after one step is d * init + (1 - d) * params (checked on a
    # fresh state: 0.9 e + 0.1 p)
    fresh = ttrainer.Trainer(_tiny_port(), ttrainer.causal_lm_task(),
                             learning_rate=1e-2, ema_decay=0.9)
    fs = fresh.init_state()
    fresh.step(fs, batch)
    for n, p in fs.params.items():
        torch.testing.assert_close(fs.ema_params[n], 0.9 * init[n] + 0.1 * p)
    # restore step 3 into another model: every tensor and the step return
    other = ttrainer.Trainer(_tiny_port(seed=9), ttrainer.causal_lm_task(),
                             learning_rate=1e-2, ema_decay=0.9)
    restored = ckpt.restore(other.init_state())
    assert restored.step == 3 and restored.opt_state["count"] == 3
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p)
        assert torch.equal(restored.ema_params[n], state.ema_params[n])
        assert torch.equal(restored.opt_state["nu"][n], state.opt_state["nu"][n])
    # evaluating the EMA weights differs from evaluating the live ones
    live = trainer.evaluate(state, [batch])
    ema = trainer.evaluate(state, [batch], use_ema=True)
    assert live["loss"] != ema["loss"]

    hb = Heartbeat(str(tmp_path / "hb-{process_index}.json"), every_steps=2)
    hb.beat(1)
    assert Heartbeat.read(str(tmp_path / "hb-0.json")) is None
    hb.beat(2)
    assert Heartbeat.read(str(tmp_path / "hb-0.json"))["step"] == 2
    assert Heartbeat.age(str(tmp_path / "hb-0.json")) >= 0
