"""A gloo world on the CPU for the port's training mesh (``parallel/``):
``run_world(runner, payload, out_dir, world)`` spawns ``world``
processes, each joins one gloo world and calls ``RUNNERS[runner](payload,
out_dir)``; each rank's return value comes back as ``results[rank]``.

Imports torch and the port only (never JAX), so the workers start
quickly. The payloads (numpy parameters, batches, configurations) and
what the runners return travel as pickles this module and its tests
write. Every worker pins ``torch.set_num_threads(1)``.

Runners:

* ``lm`` — causal-LM ``Trainer`` steps on each case's mesh (the tests
  compare them with the JAX ``Trainer`` on a fake-device mesh of the
  same shape);
* ``models`` — BERT, MoE-BERT, ResNet, Adafactor and KMeans on a mesh,
  and a checkpoint written by every rank (compared with the port's
  one-process runs);
* ``cli`` — each training CLI's ``main`` with ``--num-processes``: the
  first joins the world through the coordinator flags.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import socket


def _rank_main(rank: int, world: int, port: int, runner: str,
               payload_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(payload_path, "rb") as fh:
        payload = pickle.load(fh)
    if runner != "cli":  # the CLIs join the world themselves
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
    try:
        out = RUNNERS[runner](payload, out_dir, rank=rank, port=port)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(runner: str, payload, out_dir: str, world: int = 4,
              timeout_s: float = 240.0) -> list:
    """Run ``runner`` on every rank of a gloo world of ``world``
    processes; returns each rank's result."""
    path = os.path.join(out_dir, "payload.pkl")
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, runner, path, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"world of {world} ({runner}): exit codes {codes}")
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


# -- runners --------------------------------------------------------------


def _tensors(tree):
    import torch

    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _full_params(state) -> dict:
    """The whole parameters of a state (a mesh rank's or not), by flax
    path."""
    full = ((lambda v, k: state.spmd.full(v, k)) if state.spmd is not None
            else (lambda v, k: v))
    return {k.replace(".", "/"): full(v, k).detach().numpy().copy()
            for k, v in state.params.items()}


def _lm_model(fields: dict, params: dict):
    import torch

    from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
    from pyspark_tf_gke_tpu_torch.train.export import config_from_dict

    model = tlm.CausalLM(config_from_dict(fields), param_dtype=torch.float32)
    return model.load_params(_tensors(params))


def _lm_trainer(case: dict, params: dict, mesh):
    from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

    return ttrainer.Trainer(
        _lm_model(case["cfg"], params),
        ttrainer.TASKS["causal_lm"](case.get("vocab_chunks")),
        tx=make_optimizer(**case["opt"]), mesh=mesh,
        fsdp_min_size=case.get("min_size", 0))


def _dtensors(model) -> int:
    """Parameters of ``model`` that are DTensors (none may be: the
    kernels' wrappers see plain local tensors)."""
    from torch.distributed.tensor import DTensor

    return sum(isinstance(p, DTensor) for p in model.parameters())


def _steps(trainer, state, batches) -> list:
    import torch

    losses = []
    for batch in batches:
        local = trainer.local_batch(batch)
        state, m = trainer.step(state, {k: torch.from_numpy(v)
                                        for k, v in local.items()})
        losses.append({k: float(v) for k, v in m.items()})
    return losses


def run_lm(payload, out_dir, **_):
    """Each case: ``steps`` trainer steps of the causal LM from the
    payload's parameters on ``make_mesh(case["mesh"], "cpu")``."""
    from pyspark_tf_gke_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for name, case in payload["cases"].items():
        mesh = make_mesh(case["mesh"], "cpu")
        trainer = _lm_trainer(case, payload["params"][case["params"]], mesh)
        state = trainer.init_state()
        losses = _steps(trainer, state, case["batches"])
        query = trainer.model.layer_0.attention.query.kernel
        out[name] = {"losses": losses, "params": _full_params(state),
                     "dtensors": _dtensors(trainer.model),
                     "query_shape": tuple(query.shape)}
    return out


def _bert_case(case, mesh):
    import torch

    from pyspark_tf_gke_tpu_torch.models import bert as tb
    from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

    cfg = tb.BertConfig(**case["cfg"], dtype=torch.float32)
    model = tb.BertForPretraining(cfg, param_dtype=torch.float32)
    model.load_params(_tensors(case["params"]))
    return ttrainer.Trainer(model, ttrainer.TASKS[case["task"]](),
                            tx=make_optimizer(**case["opt"]), mesh=mesh,
                            fsdp_min_size=0)


def _resnet_case(case, mesh):
    import torch

    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet
    from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

    model = ResNet(**case["model"], dtype=torch.float32, device="cpu")
    return ttrainer.Trainer(model, ttrainer.TASKS["resnet"](),
                            tx=make_optimizer(**case["opt"]), mesh=mesh,
                            fsdp_min_size=case["min_size"])


def _model_case(case, mesh):
    """A ViT (``vit``) or CNN regressor (``regression``) trainer."""
    import torch

    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
    from pyspark_tf_gke_tpu_torch.models.vit import ViTClassifier
    from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer

    if case["task"] == "vit":
        model = ViTClassifier(BertConfig(**case["cfg"], dtype=torch.float32),
                              **case["model"], device="cpu")
        model.load_params(_tensors(case["params"]))
    else:
        model = CNNRegressor(**case["model"], device="cpu")
    return ttrainer.Trainer(model, ttrainer.TASKS[case["task"]](),
                            tx=make_optimizer(**case["opt"]), mesh=mesh,
                            fsdp_min_size=case["min_size"])


def run_case(case: dict, mesh, out_dir: str) -> dict:
    """One case of ``run_models`` on ``mesh`` (``None``: one process)."""
    from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager

    kind = case["kind"]
    if kind == "kmeans":
        from pyspark_tf_gke_tpu_torch.etl.kmeans import KMeans

        km = KMeans(**case["kw"], device="cpu", mesh=mesh).fit(case["x"])
        return {"centers": km.centers, "n_iter": km.n_iter}
    if kind == "bert":
        trainer = _bert_case(case, mesh)
    elif kind == "resnet":
        trainer = _resnet_case(case, mesh)
    elif kind == "model":
        trainer = _model_case(case, mesh)
    else:
        trainer = _lm_trainer(case, case["params"], mesh)
    state = trainer.init_state()
    res = {"losses": _steps(trainer, state, case["batches"]),
           "params": _full_params(state), "dtensors": _dtensors(trainer.model)}
    if state.batch_stats is not None:
        res["stats"] = {k: v.numpy().copy()
                        for k, v in state.batch_stats.items()}
    if "ckpt" in case:
        ckpt = CheckpointManager(os.path.join(out_dir, case["ckpt"]),
                                 async_save=case.get("async", False))
        ckpt.save(state)
        ckpt.wait()
    return res


def run_models(payload, out_dir, **_):
    """BERT / MoE-BERT / ResNet / Adafactor trainer steps, KMeans fits
    and a checkpoint, each on its case's mesh."""
    from pyspark_tf_gke_tpu_torch.parallel.mesh import make_mesh

    return {name: run_case(case, make_mesh(case["mesh"], "cpu"), out_dir)
            for name, case in payload["cases"].items()}


def run_cli(payload, out_dir, rank, port):
    """Each CLI's ``main(argv)`` in turn; the first joins the world
    through ``--num-processes``, ``--process-id`` and the coordinator
    flags (``{rank}`` and ``{port}`` in an argument are this rank's),
    and the others find it joined. Returns each run's history."""
    import importlib

    os.environ.update(payload.get("env", {}))
    out = {}
    for name, (module, argv) in payload["runs"].items():
        argv = [a.format(rank=rank, port=port) for a in argv]
        try:
            out[name] = importlib.import_module(module).main(argv)
        except SystemExit as exc:  # a refusal: the message is the result
            out[name] = str(exc)
    return out


RUNNERS = {"lm": run_lm, "models": run_models, "cli": run_cli}

