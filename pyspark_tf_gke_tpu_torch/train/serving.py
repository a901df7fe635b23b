"""Multi-process serving (counterpart of ``pyspark_tf_gke_tpu/train/
serving.py``): the tensor-parallel placement of a serving model, the
score / generate / beam / speculative entry points under a mesh, and
the announce/replay wire that keeps every rank on the same program.

A port process drives ONE card, so a model served over ``tp`` ranks is
``tp`` processes. Only rank 0 has the HTTP socket: it ANNOUNCES each
request or slot-engine op (a fixed 8-int32 header broadcast, then its
payloads, in the JAX wire's order and shapes) over a gloo group of CPU
tensors (``parallel/distributed.broadcast_one_to_all``), then runs it;
ranks 1..N-1 sit in :func:`serve_worker_loop` replaying the same call,
so every rank issues the model's device collectives (the ``tp`` group's
all-reduces and gathers) in the same order. Every decision a worker
needs travels on the wire: it decides nothing itself.

Placement (:func:`serving_shardings`, :func:`shard_params_for_serving`)
follows the model's logical axes (``parallel/sharding.LOGICAL_RULES``)
with the JAX ``fit_spec``: a dimension its extent does not divide stays
whole (a 259-token vocabulary at tp=2). int8 scales follow their
kernel: split with a column-parallel kernel, whole with a row-parallel
one; an embedding's per-row scale follows its rows. Each rank keeps its
slices of the module's tensors; no DTensor reaches a model.

Scoring: one full causal forward, then the masked per-row total
next-token NLL as plain f32 cross-entropy (:func:`serve_score`).

The entry points take no mesh (the JAX ones do): a model placed by
:func:`shard_params_for_serving` carries its groups.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM
from pyspark_tf_gke_tpu_torch.parallel.sharding import (LOGICAL_RULES,
                                                        logical_spec)

logger = logging.getLogger("torch.train.serving")


# -- placement ---------------------------------------------------------------


def _int8_scale(module, leaf: str) -> Optional[str]:
    """The attribute holding ``module.leaf``'s int8 scales, if it is an
    int8 kernel or table."""
    name = {"kernel": "kernel_scale",
            "embedding": "embedding_scale"}.get(leaf)
    if name is not None and getattr(module, name, None) is not None:
        return name
    return None


QSpec = collections.namedtuple("QSpec", "q scale")


def serving_shardings(model: CausalLM, mesh, rules=LOGICAL_RULES
                      ) -> Dict[str, tuple]:
    """``{flax path: spec}`` of every parameter of ``model`` on ``mesh``
    from its modules' logical axes (``tp`` over heads, mlp and vocab;
    whole elsewhere), any dimension its extent does not divide left
    whole (``fit_spec``). An int8 leaf's entry is a :class:`QSpec` of
    its kernel's spec and its scales': a column-parallel kernel's scales
    split with its columns, a row-parallel one's stay whole, an
    embedding's ``[rows, 1]`` scales follow its rows."""
    out = {}
    for mod_name, module in model.named_modules():
        declared = getattr(module, "logical_axes", None) or {}
        for leaf, p in module.named_parameters(recurse=False):
            path = (f"{mod_name}.{leaf}" if mod_name else leaf).replace(
                ".", "/")
            spec = logical_spec(declared.get(leaf), tuple(p.shape), mesh,
                                rules, fit=True)
            scale = _int8_scale(module, leaf)
            if scale is None:
                out[path] = spec
                continue
            full = tuple(spec) + (None,) * (p.dim() - len(spec))
            scale_spec = ((full[0],) if getattr(module, scale).dim() == 2
                          else (full[-1],))
            out[path] = QSpec(spec, scale_spec if scale_spec != (None,)
                              else ())
    return out


@torch.no_grad()
def shard_params_for_serving(model: CausalLM, mesh, rules=LOGICAL_RULES,
                             spmd=None) -> CausalLM:
    """Keep this rank's ``tp`` slices of ``model``'s parameters (and of
    its int8 scales) in place, and hand its modules the rank's groups
    (``spmd``, a ``parallel/spmd.Spmd`` of ``mesh``: made here when None;
    a draft takes its target's, as making groups is a collective): the
    model then computes its heads, its MLP columns and its vocabulary
    rows, with the collectives ``models/layers.Dense``, ``TokenEmbed``
    and the attention call. Returns ``model``. The port computes a
    rank's heads locally, so ``tp`` must divide the heads."""
    if spmd is None:
        from pyspark_tf_gke_tpu_torch.parallel.spmd import Spmd

        spmd = Spmd(mesh)
    tp = spmd.sizes["tp"]
    if model.cfg.num_heads % tp:
        raise ValueError(f"tp={tp} does not divide num_heads "
                         f"{model.cfg.num_heads}")
    specs = serving_shardings(model, mesh, rules)
    for module in model.modules():
        if hasattr(module, "spmd"):
            module.spmd = spmd
    for path, spec in specs.items():
        owner_name, _, leaf = path.replace("/", ".").rpartition(".")
        owner = model.get_submodule(owner_name)
        scale_spec = None
        if isinstance(spec, QSpec):
            spec, scale_spec = spec
        p = getattr(owner, leaf)
        local = spmd._slice(p.detach(), spec, ("tp",))
        if local.shape != p.shape:
            setattr(owner, leaf, torch.nn.Parameter(
                local.contiguous().clone(), requires_grad=False))
        if scale_spec is not None:
            name = _int8_scale(owner, leaf)
            scale = getattr(owner, name)
            setattr(owner, name, spmd._slice(scale, scale_spec,
                                             ("tp",)).contiguous().clone())
    return model


# -- the entry points under a mesh -------------------------------------------


@torch.inference_mode()
def serve_score(model: CausalLM, ids, lengths) -> np.ndarray:
    """Per-row total NLL (nats) of ``ids [B, S]``, host-readable on every
    rank (the full logits are gathered inside the model); position ``j``
    scores token ``j + 1`` while ``j + 1 < lengths[row]``. Rank 0 and a
    worker run this same function."""
    device = model.device
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.long,
                              device=device)
    logits = model(ids)
    lg = logits[:, :-1].float()
    per_tok = F.cross_entropy(lg.transpose(1, 2), ids[:, 1:],
                              reduction="none")
    mask = (torch.arange(ids.shape[1] - 1, device=device)[None, :]
            < (lengths - 1)[:, None])
    return (per_tok * mask).sum(dim=1).cpu().numpy()


def serve_generate(model: CausalLM, prompt_ids, **kwargs):
    """``generate`` on every rank (each samples the same tokens from the
    same gathered logits and the same generator seed)."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import generate

    with torch.inference_mode():
        return generate(model, prompt_ids, **kwargs).cpu()


def serve_beam(model: CausalLM, prompt_ids, max_new_tokens: int = 64,
               num_beams: int = 4, eos_token_id=None):
    """Beam search on every rank: ``(tokens, scores)`` on the host."""
    from pyspark_tf_gke_tpu_torch.models.beam_search import beam_search

    with torch.inference_mode():
        out, scores = beam_search(model, np.asarray(prompt_ids),
                                  max_new_tokens=max_new_tokens,
                                  num_beams=num_beams,
                                  eos_token_id=eos_token_id)
    return out.cpu(), scores.cpu()


# -- the wire ----------------------------------------------------------------
#
# The JAX wire's ops, header layout and payload order (its comments,
# ``train/serving.py:159-270``, are the reference):
#
# GENERATE / SCORE / SPECULATIVE: [op, batch, prompt_len, max_new_tokens,
#   eos (-1 none), aux, top_k (-1 none), extras] + the prompt [b, s]
#   int32; SCORE: + lengths [b]; extras 1: + floats [temperature, top_p,
#   repetition_penalty] (NaN = None); extras 2: + the seed as uint32 [2]
#   (the JAX key's shape: low and high words). aux = beams / gamma.
# CB_ADMIT: [op, num_slots, s_bucket, true_len, eos, slot, pad_id, flags]
#   + padded [1, s_bucket]; flags bit1: + [fill] (a chunked piece), bit2
#   the final piece, bit3: + [src, dst] (copy-on-write before the piece),
#   bit0: + [temperature, top_p] f32 + [seed] i64; a paged model: + the
#   page row [max_pages_per_slot]; bit4: + [width, prompt_len] and the
#   draft's padded prompt [1, width], last.
# CB_CHUNK: [op, num_slots, deferred, chunk (rounds), eos, has_sampling,
#   pad_id, spec_tokens]. CB_COLLECT: [op, num_slots, 0...] settles the
#   oldest deferred chunk (at most two outstanding). CB_FREE: [op,
#   num_slots, 0, 0, 0, slot, 0, 0]. CB_RESET: [op, 0...].
# KV_XFER: [op, num_slots, n_pages, n_layers, n_keys, 0, 0, 0] + pages
#   [n] int32, then for each layer and key a shape header [ndim, dims...]
#   and the rows as float32.
# KV_READ (the port's): [op, num_slots, n_pages, 0...] + pages [n]
#   int32: every rank gathers its KV heads of those pages, so rank 0's
#   export holds every head. Announced only when the pool holds a rank's
#   heads (tp > 1); the JAX wire has no such op, as its export reads a
#   global array.

OP_SHUTDOWN = 0
OP_GENERATE = 1
OP_SCORE = 2
OP_SPECULATIVE = 3
OP_CB_ADMIT = 4
OP_CB_CHUNK = 5
OP_CB_FREE = 6
OP_CB_RESET = 7
OP_CB_COLLECT = 8
OP_KV_XFER = 9
OP_KV_READ = 10
_HEADER_LEN = 8

# One announce + its device work at a time: HTTP handlers and the engine
# thread run concurrently, and interleaved broadcasts would hand workers
# one request's header with another's payload.
_MH_LOCK = threading.Lock()


def _bcast(x):
    """THE seam of the wire (tests patch it): rank 0's ``x`` on every
    rank."""
    from pyspark_tf_gke_tpu_torch.parallel.distributed import (
        broadcast_one_to_all)

    return broadcast_one_to_all(x)


def _header(*fields) -> np.ndarray:
    header = np.zeros(_HEADER_LEN, np.int32)
    header[:len(fields)] = fields
    return header


def _eos(eos_token_id) -> int:
    return -1 if eos_token_id is None else int(eos_token_id)


def process_count() -> int:
    """Ranks in the world (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def mh_lock():
    """The announce lock, for callers that drive their own announce +
    device sequences (the continuous engine)."""
    return _MH_LOCK


def announce_generate(prompt_ids, max_new_tokens: int, eos_token_id=None,
                      num_beams: int = 0, top_k=None, sampling=None) -> None:
    """Rank 0: publish a generate request (header, prompt, and for
    sampling the floats and the seed words)."""
    b, s = prompt_ids.shape
    extras = (0 if sampling is None
              else (2 if sampling["key"] is not None else 1))
    _bcast(_header(OP_GENERATE, b, s, max_new_tokens, _eos(eos_token_id),
                   num_beams, -1 if top_k is None else int(top_k), extras))
    _bcast(np.asarray(prompt_ids, np.int32))
    if sampling is not None:
        _bcast(np.asarray(sampling["floats"], np.float32))
        if sampling["key"] is not None:
            _bcast(np.asarray(sampling["key"], np.uint32))


def announce_cb_admit(num_slots: int, padded, true_len: int, slot: int,
                      eos_token_id, pad_id: int, sampling=None, pages=None,
                      chunk_fill=None, final: bool = False, cow=None,
                      draft=None) -> None:
    """Rank 0 (holding the announce lock): one slot admission or
    chunked-prefill piece. ``sampling`` the lane's ``(temperature,
    top_p, seed)`` (sent when the temperature is positive), ``pages``
    the sentinel-padded page row (paged models), ``chunk_fill`` a
    piece's start, ``final`` the piece that activates the slot, ``cow``
    the copy-on-write ``(src, dst)`` replayed before the piece, ``draft``
    the ``(padded [1, w], prompt_len)`` of the draft's prefill."""
    has_sampling = int(sampling is not None and sampling[0] > 0)
    flags = has_sampling
    if chunk_fill is not None:
        flags |= 2 | (4 if final else 0)
    if cow is not None:
        flags |= 8
    if draft is not None:
        flags |= 16
    _bcast(_header(OP_CB_ADMIT, num_slots, padded.shape[1], int(true_len),
                   _eos(eos_token_id), slot, pad_id, flags))
    _bcast(np.asarray(padded, np.int32))
    if chunk_fill is not None:
        _bcast(np.asarray([chunk_fill], np.int32))
    if cow is not None:
        _bcast(np.asarray(list(cow), np.int32))
    if has_sampling:
        # the seed as its own int64 payload: a float32 round trip would
        # corrupt it, and every rank must seed the same lane
        _bcast(np.asarray(sampling[:2], np.float32))
        _bcast(np.asarray([sampling[2]], np.int64))
    if pages is not None:
        _bcast(np.asarray(pages, np.int32))
    if draft is not None:
        _bcast(np.asarray([draft[0].shape[1], draft[1]], np.int32))
        _bcast(np.asarray(draft[0], np.int32))


def announce_kv_xfer(num_slots: int, pages, blobs) -> None:
    """Rank 0 (holding the lock): install transferred KV page rows at
    ``pages`` (``blobs``: one dict a layer, wire order), every leaf as
    float32 behind its own shape header."""
    from pyspark_tf_gke_tpu_torch.train.continuous import _KV_XFER_KEYS

    pages = np.asarray(pages, np.int32).reshape(-1)
    n_keys = len(blobs[0]) if blobs else 0
    _bcast(_header(OP_KV_XFER, num_slots, pages.size, len(blobs), n_keys))
    _bcast(pages)
    for rec in blobs:
        for key in _KV_XFER_KEYS:
            if key not in rec:
                continue
            leaf = np.asarray(rec[key], np.float32)
            shape = np.zeros(_HEADER_LEN, np.int32)
            shape[0] = leaf.ndim
            shape[1:1 + leaf.ndim] = leaf.shape
            _bcast(shape)
            _bcast(leaf)


def announce_kv_read(num_slots: int, pages) -> None:
    """Rank 0 (holding the lock): gather the KV heads of ``pages`` (an
    export under tp)."""
    pages = np.asarray(pages, np.int32).reshape(-1)
    _bcast(_header(OP_KV_READ, num_slots, pages.size))
    _bcast(pages)


def announce_cb_chunk(num_slots: int, chunk: int, eos_token_id, pad_id: int,
                      sampling: bool = False, deferred: bool = False,
                      spec_tokens: int = 0) -> None:
    """A decode chunk (``spec_tokens > 0``: a spec chunk of ``chunk``
    rounds); ``deferred`` chunks are settled by a later collect."""
    _bcast(_header(OP_CB_CHUNK, num_slots, int(deferred), chunk,
                   _eos(eos_token_id), int(sampling), pad_id,
                   int(spec_tokens)))


def announce_cb_collect(num_slots: int) -> None:
    _bcast(_header(OP_CB_COLLECT, num_slots))


def announce_cb_free(num_slots: int, slot: int) -> None:
    _bcast(_header(OP_CB_FREE, num_slots, 0, 0, 0, slot))


def announce_cb_reset() -> None:
    _bcast(_header(OP_CB_RESET))


def announce_shutdown() -> None:
    """Rank 0: release every worker from :func:`serve_worker_loop`
    (under the lock: a shutdown must not interleave with a request)."""
    with _MH_LOCK:
        _bcast(_header(OP_SHUTDOWN))


def sync_serving_config(has_draft: bool) -> None:
    """Called once at startup by every rank: rank 0's draft-bundle
    presence is broadcast and each rank compares its own, so a draft
    deployed on some ranks only fails here, not mid-collective."""
    if process_count() <= 1:
        return
    p0 = int(np.asarray(_bcast(np.int32(bool(has_draft)))))
    if bool(p0) != bool(has_draft):
        mine = "has one" if has_draft else "has none"
        theirs = "has a draft bundle" if p0 else "has no draft bundle"
        raise RuntimeError(
            f"serving config mismatch: process 0 {theirs}, process "
            f"{process_index()} {mine} - deploy identical CLI args on every "
            f"process")


def mh_speculative(model, draft_model, prompt_ids, max_new_tokens: int,
                   gamma: int = 4, eos_token_id=None):
    """Rank 0's standalone speculative path: announce, then the same
    ``speculative_generate`` the workers replay (greedy: every rank
    reads the same accept counts). Returns ``(tokens, stats)``."""
    from pyspark_tf_gke_tpu_torch.models.speculative import (
        speculative_generate)

    prompt = np.asarray(prompt_ids, np.int32)
    b, s = prompt.shape
    with _MH_LOCK:
        if process_count() > 1:
            _bcast(_header(OP_SPECULATIVE, b, s, max_new_tokens,
                           _eos(eos_token_id), gamma))
            _bcast(prompt)
        return speculative_generate(model, draft_model, prompt,
                                    max_new_tokens, gamma=gamma,
                                    eos_token_id=eos_token_id,
                                    return_stats=True)


def mh_score(model, ids, lengths) -> np.ndarray:
    """Rank 0's scoring path: announce (header, tokens, lengths), then
    the same :func:`serve_score` the workers replay."""
    ids = np.asarray(ids, np.int32)
    lengths = np.asarray(lengths, np.int32)
    b, s = ids.shape
    with _MH_LOCK:
        if process_count() > 1:
            _bcast(_header(OP_SCORE, b, s))
            _bcast(ids)
            _bcast(lengths)
        return serve_score(model, ids, lengths)


def _pack_sampling(temperature, top_p, repetition_penalty, seed):
    """The wire form of a request's sampling operands: three floats (NaN
    = None) and, when sampling, the seed's two 32-bit words. A greedy
    request with a repetition penalty packs the floats only."""
    sampling = bool(temperature and temperature > 0)
    if not sampling and repetition_penalty is None:
        return None
    if sampling and seed is None:
        raise ValueError("sampling (temperature > 0) needs a seed")
    floats = np.array([temperature if sampling else 0.0,
                       np.nan if top_p is None else top_p,
                       np.nan if repetition_penalty is None
                       else repetition_penalty], np.float32)
    key = None
    if sampling:
        s = int(seed) % (1 << 64)
        key = np.array([s & 0xFFFFFFFF, s >> 32], np.uint32)
    return {"floats": floats, "key": key}


def _unpack_sampling(floats, key) -> dict:
    """``generate`` keyword arguments of a packed sampling: rank 0
    decodes its own packing too, so both sides pass identical values."""
    t, tp, rp = (float(v) for v in floats)
    out = dict(temperature=t, top_p=None if np.isnan(tp) else tp,
               repetition_penalty=None if np.isnan(rp) else rp)
    if key is not None:
        key = np.asarray(key, np.uint32)
        seed = int(key[0]) | (int(key[1]) << 32)
        out["seed"] = seed
    return out


def _generate_kwargs(model: CausalLM, unpacked: dict) -> dict:
    """``generate`` arguments of :func:`_unpack_sampling`'s dict (the seed
    becomes a generator on the model's device)."""
    kw = dict(unpacked)
    seed = kw.pop("seed", None)
    if seed is not None:
        kw["generator"] = torch.Generator(
            device=model.device).manual_seed(seed)
    return kw


def mh_generate(model, prompt_ids, max_new_tokens: int = 64,
                eos_token_id=None, num_beams: int = 0,
                temperature: float = 0.0, top_k=None, top_p=None,
                repetition_penalty=None, seed=None):
    """Rank 0's whole-batch request path: announce, then the same
    :func:`serve_generate` (or :func:`serve_beam` for ``num_beams > 1``)
    the workers replay; sampling's floats and seed ride the wire, so
    every rank draws the same tokens. Tokens, or ``(tokens, scores)``
    on the beam path."""
    prompt = np.asarray(prompt_ids, np.int32)
    top_k = None if top_k is None else int(top_k)
    sampling = _pack_sampling(temperature, top_p, repetition_penalty, seed)
    with _MH_LOCK:
        if process_count() > 1:
            announce_generate(prompt, max_new_tokens, eos_token_id,
                              num_beams=num_beams, top_k=top_k,
                              sampling=sampling)
        if num_beams and num_beams > 1:
            return serve_beam(model, prompt, max_new_tokens=max_new_tokens,
                              num_beams=num_beams, eos_token_id=eos_token_id)
        kwargs = ({} if sampling is None else _generate_kwargs(
            model, _unpack_sampling(sampling["floats"], sampling["key"])))
        return serve_generate(model, prompt, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id, top_k=top_k,
                              **kwargs)


# -- the worker --------------------------------------------------------------

_CB_OPS = (OP_CB_ADMIT, OP_CB_CHUNK, OP_CB_FREE, OP_CB_RESET, OP_CB_COLLECT,
           OP_KV_XFER, OP_KV_READ)


def _read_cb_payloads(model: CausalLM, op: int, header) -> dict:
    """Every payload of one slot-engine op, consumed from the wire before
    any work that can fail (a failed op must leave the next header read
    aligned)."""
    _, b, s, max_new, eos, aux, tk, flags = (int(v) for v in header)
    got = {}
    if op in (OP_KV_XFER, OP_KV_READ):
        got["pages"] = np.asarray(_bcast(np.zeros(s, np.int32)))
    if op == OP_KV_XFER:
        from pyspark_tf_gke_tpu_torch.train.continuous import _KV_XFER_KEYS

        blobs = []
        for _ in range(max_new):  # n_layers
            rec = {}
            for key in _KV_XFER_KEYS[:eos]:  # n_keys
                shp = np.asarray(_bcast(np.zeros(_HEADER_LEN, np.int32)))
                dims = tuple(int(v) for v in shp[1:1 + int(shp[0])])
                rec[key] = np.asarray(_bcast(np.zeros(dims, np.float32)))
            blobs.append(rec)
        got["blobs"] = blobs
    if op == OP_CB_ADMIT:
        got["padded"] = np.asarray(_bcast(np.zeros((1, s), np.int32)))
        if flags & 2:
            got["fill"] = int(np.asarray(_bcast(np.zeros(1, np.int32)))[0])
        if flags & 8:
            got["cow"] = np.asarray(_bcast(np.zeros(2, np.int32)))
        if flags & 1:
            floats = np.asarray(_bcast(np.zeros(2, np.float32)))
            seed = int(np.asarray(_bcast(np.zeros(1, np.int64)))[0])
            got["sampling"] = (float(floats[0]), float(floats[1]), seed)
        if model.cfg.paged_kv:
            got["row"] = np.asarray(_bcast(np.zeros(
                (model.cfg.max_pages_per_slot,), np.int32)))
        if flags & 16:
            dshape = np.asarray(_bcast(np.zeros(2, np.int32)))
            got["draft"] = (np.asarray(_bcast(np.zeros(
                (1, int(dshape[0])), np.int32))), int(dshape[1]))
    return got


def _replay_cb(replica, inflight, op: int, header, got: dict) -> int:
    """One slot-engine op on the worker's replica; returns 1 for a chunk
    (a served op), else 0."""
    _, b, s, max_new, eos, aux, tk, flags = (int(v) for v in header)
    eos_id = None if eos < 0 else eos
    if op == OP_CB_ADMIT:
        samp = got.get("sampling")
        if "fill" in got:
            # a chunked-prefill piece (a radix hit's copy-on-write
            # first), the final one activating the slot
            if "cow" in got:
                replica.copy_page(int(got["cow"][0]), int(got["cow"][1]))
            logits1 = replica.prefill_chunk(got["padded"], got["fill"],
                                            max_new, got["row"])
            if flags & 4:
                replica.activate_slot(aux, got["fill"] + max_new, logits1,
                                      got["row"],
                                      samp if samp is not None
                                      else (0.0, 1.0, 0))
        else:
            replica.admit_padded(got["padded"], max_new, aux,
                                 sampling=samp, pages=got.get("row"))
        if "draft" in got:
            replica.draft_prefill_row(got["draft"][0], got["draft"][1], aux)
        return 0
    if op == OP_CB_CHUNK:
        # aux: the chunk's static sampling flag; flags: spec_tokens (> 0
        # a spec chunk of max_new rounds)
        if s:  # deferred: dispatch only, settled at the matching collect
            if len(inflight) >= 2:
                raise RuntimeError("deferred-chunk stream desynced: "
                                   f"{len(inflight)} outstanding")
            if flags > 0:
                inflight.append(replica.spec_chunk_async(
                    max_new, eos_id, tk, sampling=bool(aux), k=flags))
            else:
                inflight.append(replica.chunk_async(
                    max_new, eos_id, tk, sampling=bool(aux)))
        elif flags > 0:
            replica.spec_chunk(max_new, eos_id, tk, sampling=bool(aux),
                               k=flags)
        else:
            replica.chunk(max_new, eos_id, tk, sampling=bool(aux))
        return 1
    if op == OP_CB_COLLECT:
        if not inflight:
            raise RuntimeError("OP_CB_COLLECT with no deferred chunk")
        replica.fetch_tuple(inflight.popleft())
    elif op == OP_KV_XFER:
        replica.write_pages(got["pages"], got["blobs"])
    elif op == OP_KV_READ:
        replica.read_pages(got["pages"])
    else:  # OP_CB_FREE
        replica.free(aux)
    return 0


def serve_worker_loop(model: CausalLM,
                      draft_model: Optional[CausalLM] = None) -> int:
    """Ranks 1..N-1: replay every announced request until shutdown;
    returns the number served. ``model`` (and ``draft_model``) must be
    placed on the same mesh as rank 0's (:func:`shard_params_for_serving`).

    A whole-batch request that raises is logged and the loop continues:
    rank 0 hits the same error on its own copy and answers it. The slot
    engine's ops follow the JAX failure rules: a failed op poisons the
    replica; rank 0 rebuilds its engine and announces ``OP_CB_RESET``,
    which heals it; a slot-engine op that arrives while poisoned exits
    with ``SystemExit(14)`` (only this rank failed: its state has
    diverged, and a dead process beats corrupt tokens or a hung job)."""
    from pyspark_tf_gke_tpu_torch.train.continuous import SlotDeviceState

    served = 0
    replica = None
    poisoned = False
    # deferred chunks awaiting their collect, oldest first: rank 0
    # dispatches chunk N+1 before collecting chunk N, so two at most
    inflight = collections.deque()
    while True:
        header = np.asarray(_bcast(np.zeros(_HEADER_LEN, np.int32)))
        op, b, s, max_new, eos, aux, tk, extras = (int(v) for v in header)
        if op == OP_SHUTDOWN:
            return served
        if op in _CB_OPS:
            if op == OP_CB_RESET:
                replica, poisoned = None, False
                inflight.clear()
                continue
            if poisoned:
                logger.error(
                    "slot-engine op %d announced after this worker's replica "
                    "failed without an OP_CB_RESET between (an asymmetric "
                    "failure); exiting", op)
                raise SystemExit(14)
            got = _read_cb_payloads(model, op, header)
            try:
                if replica is None or replica.num_slots != b:
                    replica = SlotDeviceState(model, b,
                                              draft_model=draft_model)
                    # deferred chunks of a replaced replica are stale
                    inflight.clear()
                served += _replay_cb(replica, inflight, op, header, got)
            except Exception:  # noqa: BLE001 — symmetric failures heal
                logger.exception(
                    "slot-engine op %d failed; replica poisoned until "
                    "rank 0's OP_CB_RESET", op)
                replica, poisoned = None, True
                inflight.clear()
            continue
        prompt = np.asarray(_bcast(np.zeros((b, s), np.int32)))
        lengths = (np.asarray(_bcast(np.zeros(b, np.int32)))
                   if op == OP_SCORE else None)
        kwargs = {}
        if extras and op == OP_GENERATE:
            floats = np.asarray(_bcast(np.zeros(3, np.float32)))
            key = (np.asarray(_bcast(np.zeros(2, np.uint32)))
                   if extras == 2 else None)
            kwargs = _generate_kwargs(model, _unpack_sampling(floats, key))
        eos_id = None if eos < 0 else eos
        try:
            if op == OP_SPECULATIVE:
                if draft_model is None:
                    # rank 0 is inside the speculative collectives: a
                    # misdeployed worker must die, not wait
                    logger.error("speculative request announced but this "
                                 "worker has no draft bundle; exiting")
                    raise SystemExit(13)
                from pyspark_tf_gke_tpu_torch.models.speculative import (
                    speculative_generate)

                speculative_generate(model, draft_model, prompt, max_new,
                                     gamma=aux, eos_token_id=eos_id)
            elif op == OP_SCORE:
                serve_score(model, prompt, lengths)
            elif aux > 1:
                serve_beam(model, prompt, max_new_tokens=max_new,
                           num_beams=aux, eos_token_id=eos_id)
            else:
                serve_generate(model, prompt, max_new_tokens=max_new,
                               eos_token_id=eos_id,
                               top_k=None if tk < 0 else tk, **kwargs)
        except Exception:  # noqa: BLE001 — keep the control plane alive
            logger.exception("replayed request failed (continuing)")
        served += 1

