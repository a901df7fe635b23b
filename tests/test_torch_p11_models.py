"""PyTorch port, the training mesh on the other models, against the port's
own one-process runs (which the earlier slices hold against the JAX
package): one gloo world of 4 CPU ranks (``tests/torch_p11_world.py``)
runs every case on its mesh, and this process runs each case again with
no mesh on the whole batch.

* BERT classification and MLM at ``dp=2,sp=2`` (the ring attention over
  the mesh's ``sp`` axis; each rank holds 2 rows and half the sequence),
  with padding that differs by row;
* MoE-BERT (classification, an MoE layer every second layer) at
  ``dp=2,fsdp=2`` and at ``dp=2,tp=2`` (the experts' hidden units split
  on tp), the aux loss held to the global batch's;
* a tiny ResNet in ``bn``, ``fused`` and ``fused3`` at ``dp=4`` and at
  ``dp=2,fsdp=2`` with ``fsdp_min_size`` 64 (the convs split): the
  BatchNorm statistics are the global batch's, so the running
  statistics equal the one-process ones;
* a ViT (patch 8, 16^2 images) at ``fsdp=2,tp=2``, placed by its
  logical axes, and the CNN regressor at ``dp=2,fsdp=2`` with
  ``fsdp_min_size`` 64, placed by ``fsdp_spec``;
* Adafactor at ``fsdp=2,tp=2`` on an LM whose MLP kernels are factored
  and split on both dimensions;
* KMeans at ``dp=4`` over 203 rows (uneven blocks): the same ``n_iter``
  and centres;
* a checkpoint written by the 4 ranks of an ``fsdp=2,tp=2`` run (async)
  and resumed by one process with no mesh continues as the one-process
  run does.

The BERT, MoE, ResNet, ViT and CNN cases step SGD with momentum, whose
update is linear in the gradient, so the parameters stay as close as
the gradients (the first step's gradients agree to ~1e-6 relative);
Adafactor and the checkpoint's Adam normalise each update, which moves
a weight whose gradient is a rounding residual by up to lr on its sign.

Tolerances (f32): losses and metrics within 1e-5 relative; running
statistics within 2e-5; parameters after 3 steps within 2e-5 absolute
plus 1e-4 relative under momentum, and under Adafactor or Adam at most
0.1% of a leaf's elements more than 2e-5 apart and none more than 3 lr
(the key biases, whose gradient is 0 analytically, are held to 3 lr
alone); KMeans centres within 1e-6 relative (f64 sums, rounded once to
f32).
"""

import numpy as np
import pytest
import torch

import torch_p11_world as world_mod
from pyspark_tf_gke_tpu_torch.models import bert as tb
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models.vit import init_params as vit_init
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

torch.set_num_threads(1)

BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=16)
MOE = dict(BERT, num_experts=4, moe_every=2)
ADAM = dict(learning_rate=1e-2)
MOMENTUM = dict(learning_rate=5e-2, optimizer="momentum")
LM_FACTORED = dict(vocab_size=64, hidden_size=128, num_layers=1,
                   num_heads=2, intermediate_size=256, max_seq_len=32,
                   dtype="float32")
LM = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
          intermediate_size=128, max_seq_len=32, dtype="float32")


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _bert_batches(seed, task, n=3, rows=4, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(6, seq + 1, rows)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        b = {"input_ids": rng.integers(0, 64, (rows, seq)).astype(np.int32),
             "attention_mask": mask}
        if task == "bert_mlm":
            labels = np.where(rng.random((rows, seq)) < 0.3,
                              rng.integers(0, 64, (rows, seq)), -100)
            b["mlm_labels"] = np.where(mask > 0, labels, -100).astype(
                np.int64)
        else:
            b["labels"] = rng.integers(0, 2, rows).astype(np.int64)
        out.append(b)
    return out


def _lm_batches(seed, n=3, rows=8, seq=16):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, seq + 1, rows)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        out.append({"input_ids": rng.integers(0, 64, (rows, seq)).astype(
            np.int32), "attention_mask": mask})
    return out


def _images(seed, n=3, rows=8):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(0, 1, (rows, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 10, rows).astype(np.int64)}
            for _ in range(n)]


def _cases():
    cases = {}
    for task in ("bert_classification", "bert_mlm"):
        cfg = {**BERT, "sp_impl": "ring"}
        cases[f"{task}_dp2_sp2"] = {
            "kind": "bert", "mesh": {"dp": 2, "sp": 2}, "cfg": cfg,
            "task": task, "opt": MOMENTUM,
            "batches": _bert_batches(1, task),
            "params": _np(tb.init_params(tb.BertConfig(**BERT), 2, seed=3))}
    for mesh in ({"dp": 2, "fsdp": 2}, {"dp": 2, "tp": 2}):
        name = "moe_" + "_".join(f"{a}{s}" for a, s in mesh.items())
        cases[name] = {
            "kind": "bert", "mesh": mesh, "cfg": MOE,
            "task": "bert_classification", "opt": MOMENTUM,
            "batches": _bert_batches(2, "bert_classification", rows=8),
            "params": _np(tb.init_params(tb.BertConfig(**MOE), 2, seed=4))}
    for variant in ("bn", "fused", "fused3"):
        for mesh in ({"dp": 4}, {"dp": 2, "fsdp": 2}):
            name = f"resnet_{variant}_" + "_".join(
                f"{a}{s}" for a, s in mesh.items())
            cases[name] = {
                "kind": "resnet", "mesh": mesh, "min_size": 64,
                "model": dict(stage_sizes=(1, 1), num_classes=10,
                              num_filters=8, norm_variant=variant, seed=5),
                "opt": MOMENTUM, "batches": _images(6)}
    vit_cfg = {**BERT, "num_experts": 0}
    cases["vit_fsdp2_tp2"] = {
        "kind": "model", "task": "vit", "mesh": {"fsdp": 2, "tp": 2},
        "cfg": vit_cfg, "min_size": 64, "opt": MOMENTUM,
        "model": dict(num_classes=10, patch_size=8, image_size=(16, 16)),
        "batches": _images(12),
        "params": _np(vit_init(tb.BertConfig(**vit_cfg), 10, patch_size=8,
                               image_size=(16, 16), seed=13))}
    rng_cnn = np.random.default_rng(14)
    cases["cnn_dp2_fsdp2"] = {
        "kind": "model", "task": "regression", "mesh": {"dp": 2, "fsdp": 2},
        "min_size": 64, "opt": MOMENTUM,
        "model": dict(num_outputs=2, flat=True, features=(4, 8),
                      image_size=(16, 16), seed=15),
        "batches": [{"image": rng_cnn.normal(0, 1, (8, 16, 16, 3)).astype(
            np.float32), "target": rng_cnn.normal(0, 1, (8, 2)).astype(
            np.float32)} for _ in range(3)]}
    cases["adafactor_fsdp2_tp2"] = {
        "kind": "lm", "mesh": {"fsdp": 2, "tp": 2}, "cfg": LM_FACTORED,
        "opt": dict(learning_rate=1e-2, optimizer="adafactor"),
        "batches": _lm_batches(7),
        "params": _np(tlm.init_params(_lm_cfg(LM_FACTORED), seed=8))}
    cases["ckpt_fsdp2_tp2"] = {
        "kind": "lm", "mesh": {"fsdp": 2, "tp": 2}, "cfg": LM, "opt": ADAM,
        "batches": _lm_batches(9)[:2], "ckpt": "ckpt", "async": True,
        "params": _np(tlm.init_params(_lm_cfg(LM), seed=10))}
    rng = np.random.default_rng(11)
    blobs = np.concatenate([rng.normal(c, 0.5, (41, 6)) for c in range(5)]
                           )[:203].astype(np.float32)
    cases["kmeans_dp4"] = {"kind": "kmeans", "mesh": {"dp": 4}, "x": blobs,
                           "kw": dict(k=5, seed=1, max_iter=50)}
    return cases


def _lm_cfg(fields):
    from pyspark_tf_gke_tpu_torch.train.export import config_from_dict

    return config_from_dict(fields)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    out_dir = str(tmp_path_factory.mktemp("p11models"))
    ranks = world_mod.run_world("models", {"cases": cases}, out_dir)
    return cases, ranks, out_dir


def _close_params(got, want, opt):
    lr = opt["learning_rate"]
    for path, value in want.items():
        diff = np.abs(np.asarray(got[path]) - value)
        if opt.get("optimizer") == "momentum":
            np.testing.assert_allclose(got[path], value, rtol=1e-4,
                                       atol=2e-5, err_msg=path)
            continue
        assert diff.max() <= 3 * lr, path
        if not path.endswith("attention/key/bias"):
            assert (diff > 2e-5).mean() <= 1e-3, (path, diff.max())


def _check_run(got, want, opt):
    assert got["dtensors"] == 0  # the kernels see plain local tensors
    assert len(got["losses"]) == len(want["losses"])
    for g, w in zip(got["losses"], want["losses"]):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-7,
                                       err_msg=key)
    _close_params(got["params"], want["params"], opt)
    for name, value in want.get("stats", {}).items():
        np.testing.assert_allclose(got["stats"][name], value, atol=2e-5,
                                   rtol=1e-5, err_msg=name)


MESH_CASES = ["bert_classification_dp2_sp2", "bert_mlm_dp2_sp2",
              "moe_dp2_fsdp2", "moe_dp2_tp2"] + [
    f"resnet_{v}_{m}" for v in ("bn", "fused", "fused3")
    for m in ("dp4", "dp2_fsdp2")] + ["vit_fsdp2_tp2", "cnn_dp2_fsdp2",
                                      "adafactor_fsdp2_tp2"]


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_run_matches_one_process(world, case, tmp_path):
    cases, ranks, _ = world
    want = world_mod.run_case(cases[case], None, str(tmp_path))
    for rank in ranks:
        _check_run(rank[case], want, cases[case]["opt"])
    if "stats" in want:
        assert want["stats"], "the ResNet keeps running statistics"
        # the running statistics moved: the global batch's, not zeros
        assert any(np.abs(v).max() > 1e-3 for v in want["stats"].values())


def test_moe_aux_loss_is_the_global_batchs(world, tmp_path):
    cases, ranks, _ = world
    want = world_mod.run_case(cases["moe_dp2_fsdp2"], None, str(tmp_path))
    aux = [step["moe_aux_loss"] for step in want["losses"]]
    assert all(a > 0 for a in aux)
    for rank in ranks:
        np.testing.assert_allclose(
            [step["moe_aux_loss"] for step in rank["moe_dp2_fsdp2"]["losses"]],
            aux, rtol=1e-5)


def test_kmeans_over_ranks_equals_one_process(world, tmp_path):
    cases, ranks, _ = world
    want = world_mod.run_case(cases["kmeans_dp4"], None, str(tmp_path))
    for rank in ranks:
        assert rank["kmeans_dp4"]["n_iter"] == want["n_iter"] > 1
        np.testing.assert_allclose(rank["kmeans_dp4"]["centers"],
                                   want["centers"], rtol=1e-6, atol=1e-7)


def test_checkpoint_from_four_ranks_resumes_on_one(world, tmp_path):
    """The 4 ranks' async save is the full state; one process with no
    mesh restores it and its third step equals the one-process run's."""
    cases, ranks, out_dir = world
    case = dict(cases["ckpt_fsdp2_tp2"])
    third = _lm_batches(9)[2]
    whole_case = {k: v for k, v in case.items() if k != "ckpt"}
    whole = world_mod.run_case({**whole_case, "batches": _lm_batches(9)},
                               None, str(tmp_path))
    model = world_mod._lm_model(case["cfg"], case["params"])
    trainer = ttrainer.Trainer(model, ttrainer.TASKS["causal_lm"](),
                               tx=make_optimizer(**ADAM))
    state = CheckpointManager(f"{out_dir}/ckpt").restore(trainer.init_state())
    assert state.step == 2
    for path, value in ranks[0]["ckpt_fsdp2_tp2"]["params"].items():
        np.testing.assert_array_equal(
            state.params[path.replace("/", ".")].detach().numpy(), value)
    state, m = trainer.step(state, {k: torch.from_numpy(v)
                                    for k, v in third.items()})
    for key, value in whole["losses"][2].items():
        np.testing.assert_allclose(float(m[key]), value, rtol=1e-5,
                                   err_msg=key)
    _close_params({k.replace(".", "/"): v.detach().numpy()
                   for k, v in state.params.items()}, whole["params"], ADAM)
