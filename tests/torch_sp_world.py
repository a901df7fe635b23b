"""A gloo world on the CPU for the port's sequence-parallel attention:
``run_world(inputs, out_dir)`` spawns one world of processes, as many
as the largest sp size in ``inputs``, and splits it into sp groups of
each size (``[0, 1]`` and ``[2, 3]`` for 2 in a world of 4; the whole
world for 4). Each rank runs :func:`_rank_main`: for every size, its
group's sequence block of that size's inputs, written with its outputs
and gradients to ``out_dir/rank{r}.npz``.

Imports torch and the port only (never JAX), so the spawned workers
start quickly; ``tests/test_torch_sp_attention.py`` compares what they
wrote with the JAX package's ops on an sp mesh.

The cases every rank runs, on ``q/k/v [B, S, H, D]`` and ``mask [B,
S]``: ``(name, op, causal, use_flash, masked)`` below; each records the
output block and the gradients of ``sum(out ** 2)`` (summed over the
group's ranks) with respect to the rank's q/k/v blocks. With ``bert``
in a size's inputs, a ``BertForPretraining`` given the group as its sp
group runs its ring (dense and flash engines) and Ulysses variants on
the rank's block of ``ids``/``ids_mask``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket

import numpy as np

ATTENTION_CASES = (
    ("ring", "ring", False, False, True),
    ("ring_causal", "ring", True, False, True),
    ("ring_flash", "ring", False, True, True),
    ("ulysses", "ulysses", False, False, True),
    ("ulysses_causal", "ulysses", True, False, True),
    ("ulysses_flash", "ulysses", False, True, True),
)
BERT_VARIANTS = (("bert_ring", "ring", None), ("bert_ring_flash", "ring", True),
                 ("bert_ulysses", "ulysses", None))


def _block(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    s = x.shape[1] // world
    return np.ascontiguousarray(x[:, rank * s:(rank + 1) * s])


def _group_ranks(world: int, n: int) -> list:
    """The sp groups of ``n`` in a world: consecutive runs of ranks."""
    return [list(range(s, s + n)) for s in range(0, world, n)]


def _group(rank: int, world: int, n: int):
    """This rank's sp group of ``n`` (the whole world for ``n ==
    world``); every rank makes every group, as ``new_group`` asks."""
    import torch.distributed as dist

    if n == world:
        return dist.group.WORLD
    groups = [(ranks, dist.new_group(ranks))
              for ranks in _group_ranks(world, n)]
    return next(g for ranks, g in groups if rank in ranks)


def _rank_main(rank: int, world: int, port: int, inputs: str,
               out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        data = dict(np.load(inputs, allow_pickle=False))
        out = {}
        for n in sorted({int(k.split("/")[0][2:]) for k in data}):
            group = _group(rank, world, n)
            mine = {k[len(f"sp{n}/"):]: x for k, x in data.items()
                    if k.startswith(f"sp{n}/")}
            cases = _attention(mine, dist.get_rank(group), n, group)
            if "bert/cfg" in mine:
                cases.update(_bert(mine, dist.get_rank(group), n, group))
            out.update({f"sp{n}/{k}": x for k, x in cases.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _attention(data, rank, world, group):
    import torch

    from pyspark_tf_gke_tpu_torch.ops.attention import (ring_attention,
                                                        ulysses_attention)

    ops = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    mask = torch.from_numpy(_block(data["mask"], rank, world))
    for name, op, causal, use_flash, masked in ATTENTION_CASES:
        q, k, v = (torch.from_numpy(_block(data[t], rank, world))
                   .requires_grad_() for t in ("q", "k", "v"))
        o = ops[op](q, k, v, group, kv_mask=mask if masked else None,
                    causal=causal, use_flash=use_flash)
        (o ** 2).sum().backward()
        out[f"{name}/out"] = o.detach().numpy()
        for t, x in (("dq", q), ("dk", k), ("dv", v)):
            out[f"{name}/{t}"] = x.grad.numpy()
    return out


def _bert(data, rank, world, group):
    import dataclasses

    import torch

    from pyspark_tf_gke_tpu_torch.models import bert as tb

    fields = dict(zip(("vocab_size", "hidden_size", "num_layers",
                       "num_heads", "intermediate_size",
                       "max_position_embeddings"),
                      (int(x) for x in data["bert/cfg"])))
    params = {k[len("bert/p/"):]: torch.from_numpy(v)
              for k, v in data.items() if k.startswith("bert/p/")}
    ids = torch.from_numpy(_block(data["ids"], rank, world))
    ids_mask = torch.from_numpy(_block(data["ids_mask"], rank, world))
    out = {}
    base = tb.BertConfig(**fields, dtype=torch.float32)
    for name, impl, use_flash in BERT_VARIANTS:
        cfg = dataclasses.replace(base, sp_impl=impl, use_flash=use_flash)
        model = tb.BertForPretraining(cfg, sp_group=group).load_params(params)
        with torch.no_grad():
            hidden, _ = model.encoder(ids, attention_mask=ids_mask)
            preds = model(ids, attention_mask=ids_mask)
        out[f"{name}/hidden"] = hidden.numpy()
        out[f"{name}/mlm_logits"] = preds["mlm_logits"].numpy()
        out[f"{name}/cls_logits"] = preds["cls_logits"].numpy()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(inputs: dict, out_dir: str, timeout_s: float = 240.0) -> dict:
    """Run every case at every sp size of ``inputs`` (``{n: arrays}``)
    in one gloo world; returns ``{n: [group, ...]}``, each group
    ``{key: [its rank 0's array, its rank 1's, ...]}``."""
    world = max(inputs)
    path = os.path.join(out_dir, "inputs.npz")
    np.savez(path, **{f"sp{n}/{k}": x for n, arrays in inputs.items()
                      for k, x in arrays.items()})
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, path, out_dir))
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
        raise RuntimeError(f"sp world of {world}: exit codes {codes}")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(world)]
    results = {}
    for n in inputs:
        keys = [k for k in ranks[0] if k.startswith(f"sp{n}/")]
        results[n] = [{k[len(f"sp{n}/"):]: [ranks[r][k] for r in group]
                       for k in keys}
                      for group in _group_ranks(world, n)]
    return results
