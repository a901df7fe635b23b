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
  first joins the world through the coordinator flags (and the serving
  CLI's, ``tests/test_torch_p11_serve_cli.py``);
* ``serve`` — the multi-process serve wire: rank 0 drives announcing
  slot engines and whole-batch requests, the other ranks replay them in
  ``serve_worker_loop``.
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
    if runner not in ("cli", "serve_cli"):  # the CLIs join it themselves
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


def _serve_model(fields: dict, params: dict, mesh, spmd=None):
    """A serving causal LM from the payload's port parameters, placed on
    ``mesh`` (this rank's tp slices; a draft takes its target's groups,
    ``spmd``)."""
    from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
    from pyspark_tf_gke_tpu_torch.train.export import config_from_dict
    from pyspark_tf_gke_tpu_torch.train.serving import (
        shard_params_for_serving)

    model = tlm.CausalLM(config_from_dict(fields))
    model.load_params(params).eval()
    return shard_params_for_serving(model, mesh, spmd=spmd)


def _engine_run(engine, specs) -> list:
    rids = [engine.submit(p, max_new_tokens=m, **kw) for p, m, kw in specs]
    done = dict(engine.run_until_drained())
    return [done[r] for r in rids]


def _serve_rank0(case, model, draft) -> dict:
    """Rank 0 of a serve case: each slot engine announces its ops (a
    reset before every engine after the first), then the whole-batch
    paths and the KV handoff; finally the shutdown."""
    import numpy as np

    from pyspark_tf_gke_tpu_torch.train import serving
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    out = {}
    for i, (name, kw, specs) in enumerate(case["engines"]):
        if i:
            with serving.mh_lock():
                serving.announce_cb_reset()
        eng = ContinuousEngine(model, announce=True,
                               draft_model=draft if kw.get("spec_tokens")
                               else None, **kw)
        if "import" in case and name == "xfer":
            tokens, layers = case["import"]
            out["imported"] = eng.import_prefix_pages(tokens, layers)
        out[name] = _engine_run(eng, specs)
        if kw.get("spec_tokens"):
            out[name + "_accepted"] = eng._n_spec_accepted
        if "export" in case and name == "xfer":
            eng.warm_prefix(case["export"])
            blob = eng.export_prefix_pages(case["export"])
            out["export"] = (blob["token_ids"], blob["layers"])
    for name, kw in case.get("whole", {}).items():
        got = serving.mh_generate(model, np.asarray(kw.pop("prompt")), **kw)
        out[name] = ([t.numpy() for t in got] if isinstance(got, tuple)
                     else got.numpy())
    if "spec_prompt" in case:
        toks, stats = serving.mh_speculative(model, draft,
                                             case["spec_prompt"], 8, gamma=3)
        out["mh_spec"] = np.asarray(toks)
        out["mh_spec_accepted"] = int(stats["accepted"])
    serving.announce_shutdown()
    return out


def run_serve(payload, out_dir, rank, **_):
    """Each case on ``make_mesh(case["mesh"], "cpu")``: rank 0 drives the
    slot engines and whole-batch requests with ``announce=True``, every
    other rank replays them in ``serve_worker_loop`` and records the
    whole-batch outputs its replay computed."""
    from pyspark_tf_gke_tpu_torch.parallel.mesh import make_mesh
    from pyspark_tf_gke_tpu_torch.train import serving

    out = {}
    for name, case in payload["cases"].items():
        mesh = make_mesh(case["mesh"], "cpu")
        model = _serve_model(case["cfg"], case["params"], mesh)
        draft = (_serve_model(case["draft_cfg"], case["draft_params"], mesh,
                              model.spmd)
                 if "draft_cfg" in case else None)
        if rank == 0:
            out[name] = _serve_rank0(case, model, draft)
            continue
        seen = []
        real = serving.serve_generate, serving.serve_beam

        def gen(*a, **k):
            seen.append(real[0](*a, **k).numpy())
            return seen[-1]

        def beam(*a, **k):
            seen.append([t.numpy() for t in real[1](*a, **k)])
            return seen[-1]

        serving.serve_generate, serving.serve_beam = gen, beam
        try:
            served = serving.serve_worker_loop(model, draft_model=draft)
        finally:
            serving.serve_generate, serving.serve_beam = real
        out[name] = {"whole": seen, "served": served}
    return out


def _http(url: str, path: str, body=None, headers=None, timeout=120):
    """``(status, parsed JSON or the SSE lines)`` of one request."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            status = resp.status
    except urllib.error.HTTPError as exc:
        raw, status = exc.read().decode(), exc.code
    if raw.startswith((":", "data:")):
        return status, [line for line in raw.splitlines()
                        if line.startswith("data:")]
    return status, json.loads(raw)


def _client(url: str, calls: list, out: dict) -> None:
    """Rank 0's client: wait for ``/healthz``, make ``calls`` in turn,
    then SIGTERM this process with the last one in flight (the drain
    must answer it)."""
    import signal
    import threading
    import time

    for _ in range(600):
        try:
            out["healthz"] = _http(url, "/healthz", timeout=5)
            break
        except OSError:
            time.sleep(0.2)
    for name, path, body, headers in calls[:-1]:
        out[name] = _http(url, path, body, headers)
    name, path, body, headers = calls[-1]

    def last():
        out[name] = _http(url, path, body, headers)

    inflight = threading.Thread(target=last)
    inflight.start()
    time.sleep(0.5)
    os.kill(os.getpid(), signal.SIGTERM)
    inflight.join(120)


def run_serve_cli(payload, out_dir, rank, port):
    """Each run: ``serve.main(argv)`` on every rank (``{rank}``, ``{port}``
    and ``{http}`` in an argument are this rank's, the world's and rank
    0's HTTP port); rank 0 also runs the run's ``calls`` from a client
    thread, the last one drained by a SIGTERM. Returns each run's exit
    code (or the error's text) and rank 0's responses."""
    import threading

    from pyspark_tf_gke_tpu_torch.train import serve

    os.environ.update(payload.get("env", {}))
    out = {}
    for name, run in payload["runs"].items():
        http = run.get("http_port", 0)
        argv = [a.format(rank=rank, port=port, http=http)
                for a in run["argv"][rank]]
        got = {}
        client = None
        if rank == 0 and run.get("calls"):
            client = threading.Thread(target=_client, args=(
                f"http://127.0.0.1:{http}", run["calls"], got))
            client.start()
        try:
            got["exit"] = serve.main(argv)
        except Exception as exc:  # noqa: BLE001 — the refusal is the result
            got["exit"] = f"{type(exc).__name__}: {exc}"
        if client is not None:
            client.join(120)
        out[name] = got
    return out


RUNNERS = {"lm": run_lm, "models": run_models, "cli": run_cli,
           "serve": run_serve, "serve_cli": run_serve_cli}

