"""Slot-based continuous batching over a paged KV pool, or a dense slot
cache (the core of ``pyspark_tf_gke_tpu/train/continuous.py``).

A fixed pool of ``num_slots`` request slots decodes together; requests
arrive and finish at different times and every free slot is refilled
at the next chunk boundary. Admission prefills prompts right-padded to
a length bucket (exact under causal attention: no real token sees the
padding after it), batching the FIFO prefix of the queue that shares a
bucket into ONE forward, and scatters the dense prefill K/V into the
pages the engine allocated for each slot. A decode chunk runs ``size``
slot-decode steps in the emit-then-step order of ``generate``: emit
token t from the carried logits, then run the model at each row's own
position. Dead rows (free slot, or past eos) keep computing with a pad
token at their FROZEN position; their emitted tokens are ``pad_id``.

The decode chunk is ONE body (``_decode_chunk``) that updates the slot
state in place. The CPU runs it eagerly; on CUDA the engine captures it
as one CUDA graph for each ``(size, sampling)`` the first time that pair
is dispatched (a warm-up on a side stream first, one memory pool shared
by every graph) and replays the graph from then on — the counterpart of
the JAX engine's jitted ``lax.scan``. Sizes come only from ``chunk``,
the step-token budget and ``adaptive_chunk``, so there are at most 2 x
(log2(chunk) + 1) graphs. A failed capture raises; nothing falls back to
eager launches. Admission writes into the same storage (index writes,
never rebinding), so a graph replays over whatever slots are live.

Sampling runs over ALL rows when any live row samples (a static
``sampling`` flag, as the JAX engine's): greedy rows take the argmax and
their stream is bit-identical to an all-greedy chunk; sampled rows draw
Gumbel noise from a counter-based hash of the slot's seed key and its
step counter (both ``[B]`` tensors written at admission), so each
slot's stream depends only on its own seed, and the captured stream
equals the eager one. Deterministic per (prompt, seed), not bit-equal to
JAX's threefry stream.

The engine owns the page pool on the host: a free list plus refcounts,
allocation at admission and release at finish — no allocation inside
a chunk. A freed slot's block-table row goes back to the sentinel, so
its dead-row writes can never land in pages handed to another request.
All of the engine's device work runs on one stream, so device order is
host dispatch order: a page freed on the host while a chunk is still in
flight is reused only by work queued after that chunk.

Chunked prefill (``prefill_chunk``): a prompt longer than
``prefill_chunk`` admits piecewise, one piece a step, each written
straight into the page pool through the admission's own page row
(``_paged_prefill_chunk``) while the reserved slot's table row stays at
the sentinel. ``step_token_budget`` caps one step's work (the piece plus
live slots x decode steps) by shrinking the decode chunk
(``_budget_cap``).

Decode-ahead (``pipeline_depth``): up to N dispatched chunks stay
un-collected; each chunk's tokens and live flags are copied into pinned
host buffers on the engine's stream behind a CUDA event, and the collect
waits on that event, so the next step's host work overlaps the chunk's
compute. ``adaptive_chunk`` sizes each dispatch to the smallest
remaining budget over the live slots (powers of two from
``_MIN_ADAPTIVE_CHUNK``). Every step that did work closes one
``StepRecord`` (``obs/stepstats.py``).

Radix prefix cache (``prefix_cache_size``): completed prompts' pages stay
resident, indexed by a token trie (``RadixPrefixCache``); a new prompt
shares its longest cached prefix at page granularity (copy-on-write for
a partially matched tail page) and prefills only the suffix, its pieces
starting at the match boundary. ``warm_prefix`` fills trie-owned pages
directly; ``export_prefix_pages`` / ``import_prefix_pages`` hand cached
pages between engines (and, through ``train/kv_transfer.py``, between
this package and the JAX one).

Speculative decoding (``spec_tokens=k``, ``draft_model``): every dispatch
is a spec chunk (``_spec_chunk``): rounds of k draft proposals a slot
and one (k+1)-wide verify of the target through K1's chunk entry, the
shared acceptance rule of ``models/speculative.py``, the rollback a
position that does not advance. The draft (the target itself when none
is given) runs a dense cache of its own, prefilled at each admission;
on CUDA each ``(rounds, k, sampling)`` chunk is one captured graph,
replayed as the decode chunk is.

Admission order and deadlines: ``schedule="fifo"`` admits in arrival
order, ``"longest"`` keeps the queue sorted by budget (LPT). Once two
distinct tenants have submitted, a deficit-weighted round robin
(``DwrrScheduler``, weights from ``tenant_weights``) picks between the
tenants' subqueues and batched admission stands down. A request's
``deadline_s`` is enforced at the chunk boundary (``_expire_deadlines``:
queued requests never admit, in-slot ones free their slot through the
route ``cancel`` takes, a piecewise admission drops its pages), and
``on_tokens`` receives each collected token group on the host, after the
chunk's event (never from a captured region).

Observability: the engine increments the JAX engine's ``serve_`` families
(``obs``, a ``platform_families`` dict) at admission and collect
boundaries, and annotates a traced request's span there (queue wait and
admission, each prefill piece, the first token and each later token
group, the ``spec`` summary and one terminal), as the JAX engine does;
an untraced request costs one ``None`` check at each. The chaos points
``engine.admit`` (after the page allocation) and ``engine.device_step``
(on the host before each chunk's dispatch or graph replay, never inside
a captured region) fire as the JAX engine's.

A model without ``kv_num_pages`` runs the same engine over a dense
``[num_slots, max_seq_len]`` cache, with the JAX engine's dense routes:
admissions copy prefill rows into the slot (``_insert_slots_batch``),
``prefix_cache_size`` keeps an LRU of batch-1 prefix caches
(``PrefixCache``; a hit extends a clone of the entry by the remainder),
chunked prefill extends a batch-1 staging cache piece by piece, and the
spec verify runs over the dense cache. There are no pages to move: the
KV handoff and the page reads and writes raise, as the JAX engine's do.

The device half is :class:`SlotDeviceState` (the slot state, the draft
slots, the captured chunks and every op on them); the engine keeps the
host half (queue, pages and refcounts, the radix trie, scheduling,
deadlines, step stats). With ``announce`` (rank 0 of a multi-process
server, ``train/serving.py``) each device op is published on the serve
wire before it runs, under the announce lock (``_announced``, at the
JAX engine's sites), and the workers' replicas replay it: batched
admission, the dense prefix LRU and dense chunked prefill are
single-host, as in the JAX engine, and ``pipeline_depth`` over 1
raises. On a tp mesh (a model placed by ``shard_params_for_serving``)
the chunks run eagerly when the tp group is gloo's, whose collectives
cannot be captured (``captured``).

The attribute names ``_queue``, ``_slots``, ``_admitting``,
``_inflight_q``, ``_page_refs``, ``_free_pages``, ``_slot_pages`` and
``radix`` match the JAX engine so its invariant checker can run here.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.chaos.inject import chaos_fire
from pyspark_tf_gke_tpu_torch.models import lanes
from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM, DenseCache,
                                                       PagedKV,
                                                       _filter_logits,
                                                       kv_heads_of)
from pyspark_tf_gke_tpu_torch.models.speculative import (accept_and_correct,
                                                         emit_window)
from pyspark_tf_gke_tpu_torch.obs.metrics import platform_families
from pyspark_tf_gke_tpu_torch.obs.stepstats import (StepStatsRing,
                                                    flops_per_token)
from pyspark_tf_gke_tpu_torch.obs.trace import annotate_request_shape
from pyspark_tf_gke_tpu_torch.ops import graphs
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("torch.train.continuous")

PAD_BUCKETS = (32, 64, 128, 256, 512, 1024)

# Smallest chunk the budget-aligned adaptive scheduler dispatches: floors
# the graph count (adaptive sizes are powers of two between this and the
# engine's ``chunk``) and bounds the overshoot on a sub-minimum remainder.
_MIN_ADAPTIVE_CHUNK = 8

# the paged leaves of a KV-page transfer, in wire order (as the JAX
# engine's ``_KV_XFER_KEYS``)
_KV_XFER_KEYS = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")

# spec chunks' accept counts over this many collected chunks make the
# windowed ``spec_accept_rate``
_SPEC_WINDOW = 64


def bucket_length(n: int, buckets: Sequence[int] = PAD_BUCKETS) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def wire_layer_order(num_layers: int) -> List[int]:
    """Layer indices in the order a KV-page transfer carries them: the
    JAX engine walks its cache tree's ``layer_{i}`` keys sorted as
    strings (0, 1, 10, 11, 2, ...), and a blob is byte-compatible only
    in that order."""
    return sorted(range(num_layers), key=lambda i: f"layer_{i}")


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # [S_true] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    # the fairness identity: the DWRR scheduler arbitrates between
    # tenants' subqueues, the serving front's quota buckets charge and
    # refund per tenant
    tenant: str = "default"
    # time.monotonic() at submit (/loadz queue_delay_ms is the age of
    # the oldest queued request)
    enqueued_at: float = 0.0
    # streaming: called with each collected token group on the engine's
    # driver thread (keep it cheap: enqueue and return)
    on_tokens: Optional[Callable[[List[int]], None]] = None
    temperature: float = 0.0      # 0 = greedy
    top_p: Optional[float] = None
    seed: int = 0
    # absolute time.monotonic() deadline (None = none); past it the
    # request expires at the next chunk boundary
    deadline: Optional[float] = None
    expired: bool = False
    # speculative decoding: draft tokens proposed / accepted for THIS
    # request while it still had budget
    spec_proposed: int = 0
    spec_accepted: int = 0
    # the request's trace span (obs/trace.py, or None): the engine
    # annotates its queue wait, admission, prefill pieces, first token,
    # token groups and terminal onto it, never per token
    span: Optional[object] = None
    last_emit: Optional[float] = None  # time of the last token delivery

    def sampling(self) -> tuple:
        return (float(self.temperature),
                float(self.top_p if self.top_p is not None else 1.0),
                int(self.seed))


def _request_cost(req: _Request) -> int:
    """A request's worst-case token footprint, prompt + budget: what the
    DWRR deficit pays for admission and the quota buckets charge."""
    return int(req.prompt.size) + int(req.max_new_tokens)


class DwrrScheduler:
    """Deficit-weighted round robin over per-tenant subqueues (the JAX
    engine's ``DwrrScheduler``, line for line).

    Each tenant's subqueue is its arrival-ordered subsequence of the
    engine's admission queue (FIFO or LPT within a tenant). Every
    rotation visit banks ``quantum * weight`` tokens of deficit; a
    tenant admits its head-of-line request when its deficit covers the
    request's cost (prompt + budget), paying the cost on admission. Over
    a saturated queue the admitted-token shares converge to the weight
    ratio whatever the request sizes, and an idle tenant's deficit is
    dropped the moment its subqueue empties (no banked credit).

    Host bookkeeping only: the engine consults :meth:`pick` only once
    it has seen two distinct tenants, so a single-tenant engine keeps
    its FIFO / LPT order exactly."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 quantum: int = 256):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.weights: Dict[str, float] = {}
        for name, w in (weights or {}).items():
            w = float(w)
            if w <= 0:
                raise ValueError(
                    f"tenant {name!r} weight must be > 0, got {w}")
            self.weights[name] = w
        self.quantum = int(quantum)
        self._deficit: Dict[str, float] = {}
        self._rr: Deque[str] = deque()  # rotation over queued tenants
        # cumulative admitted token cost per tenant (stats, and what the
        # shares converge over)
        self.admitted_tokens: Dict[str, int] = {}

    def weight(self, tenant: str) -> float:
        """The configured weight; an unknown tenant takes the ``*``
        entry's, else 1.0."""
        w = self.weights.get(tenant)
        if w is None:
            w = self.weights.get("*", 1.0)
        return float(w)

    def pick(self, queue: List[_Request]) -> int:
        """Index into ``queue`` of the request to admit next. The
        rotation and deficits persist across calls; a tenant that left
        the queue is dropped with its deficit."""
        heads: Dict[str, int] = {}
        for i, req in enumerate(queue):
            if req.tenant not in heads:
                heads[req.tenant] = i
        if len(heads) <= 1:
            return 0  # one tenant queued: its own order stands
        present = set(heads)
        for t in list(self._deficit):
            if t not in present:
                del self._deficit[t]
        if any(t not in present for t in self._rr):
            self._rr = deque(t for t in self._rr if t in present)
        for t in heads:  # first-appearance order joins at the back
            if t not in self._rr:
                self._rr.append(t)
        # rotate, banking quanta, until a head of line is affordable; the
        # bound only turns a pathological weight/quantum into round robin
        for _ in range(10000):
            t = self._rr[0]
            cost = _request_cost(queue[heads[t]])
            if self._deficit.get(t, 0.0) >= cost:
                return heads[t]
            self._deficit[t] = (self._deficit.get(t, 0.0)
                                + self.quantum * self.weight(t))
            self._rr.rotate(-1)
        return heads[self._rr[0]]

    def charge(self, req: _Request) -> None:
        """Pay one admitted request's cost from its tenant's deficit and
        tally it."""
        t = req.tenant
        cost = _request_cost(req)
        self._deficit[t] = self._deficit.get(t, 0.0) - cost
        self.tally(req)

    def tally(self, req: _Request) -> None:
        """Count an admitted request's cost (every admission route)."""
        self.admitted_tokens[req.tenant] = (
            self.admitted_tokens.get(req.tenant, 0) + _request_cost(req))


# -- the sampling lanes' counter-based draws (models/lanes.py) ------------------

_seed_key = lanes.seed_key


def _gumbel(state: "SlotState", stream: int = lanes.PICK) -> torch.Tensor:
    """``[B, V]`` Gumbel noise: each row's from its key, its step counter
    and ``stream`` only, each column from its vocabulary index."""
    return lanes.gumbel(state.keys, state.draws, stream, state.vocab_mix)


class SlotState:
    """The slot pool's device state (``_paged_zeros_state``, or the dense
    ``_zeros_state``): the cache — the paged pool of a paged model, else
    a dense ``[num_slots, max_seq_len, H_kv, D]`` cache a layer (int8
    under ``kv_cache_quant``) — per-slot fill levels, carried logits,
    live flags and sampling lanes (temperature, top-p, seed key, step
    counter). Every tensor is allocated once and written in place — a
    captured chunk replays over this storage."""

    def __init__(self, model: CausalLM, num_slots: int,
                 device: torch.device):
        cfg = model.cfg
        heads = model.kv_cache_heads
        self.cache = (PagedKV(cfg, num_slots, device, heads) if cfg.paged_kv
                      else DenseCache(cfg, num_slots, cfg.max_seq_len,
                                      device, heads))
        self.positions = torch.zeros(num_slots, dtype=torch.long,
                                     device=device)
        self.last_logits = torch.zeros(num_slots, cfg.vocab_size,
                                       device=device)
        self.live = torch.zeros(num_slots, dtype=torch.bool, device=device)
        self.temps = torch.zeros(num_slots, device=device)
        self.topps = torch.ones(num_slots, device=device)
        self.keys = torch.zeros(num_slots, dtype=torch.long, device=device)
        self.draws = torch.zeros(num_slots, dtype=torch.long, device=device)
        self.vocab_mix = lanes.column_mix(cfg.vocab_size, device)

    def carried(self) -> List[torch.Tensor]:
        """The tensors a decode chunk rewrites (besides the KV pages)."""
        return [self.positions, self.last_logits, self.live, self.draws]


def _h2d(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; on CUDA through pinned memory and
    queued on the stream, so an admission never waits for an in-flight
    chunk."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _prefill_padded_batch(model: CausalLM, padded: np.ndarray,
                          true_lens: np.ndarray,
                          length: Optional[int] = None):
    """Right-padded prefill of ``[k, S_bucket]`` prompts in ONE forward.
    Returns the dense ``[k, length]`` cache (``length`` defaults to the
    bucket; a staging cache that later extends takes ``max_seq_len``)
    and the logits at each row's last real token ``[k, V]``."""
    device = model.device
    ids = _h2d(padded.astype(np.int64), device)
    last = _h2d(true_lens.astype(np.int64) - 1, device)
    cache = DenseCache(model.cfg, padded.shape[0],
                       length if length is not None else padded.shape[1],
                       device, model.kv_cache_heads)
    logits = model(ids, cache=cache, prefill=True, last_index=last)
    return cache, logits[:, 0]


def _prefill_padded(model: CausalLM, padded: np.ndarray,
                    true_len: int) -> tuple:
    """Batch-1 prefill of the right-padded ``padded [w]`` into a fresh
    ``[1, max_seq_len]`` staging cache: ``(cache1, logits1 [1, V])``."""
    return _prefill_padded_batch(model, padded[None],
                                 np.asarray([true_len]),
                                 length=model.cfg.max_seq_len)


def _extend_prefix(model: CausalLM, cache, padded: np.ndarray, fill: int,
                   true_len: int) -> torch.Tensor:
    """Extend a batch-1 cache at fill level ``fill`` with the right-padded
    ``padded [w]`` in ONE multi-token slot-decode forward: K/V for every
    position ``fill + arange(w)`` are written IN PLACE and the causal
    offset mask keeps every real token blind to the padding after it.
    ``cache`` is a dense staging cache or a paged view. Returns the
    logits at the last REAL token ``[1, V]``."""
    device = model.device
    w = padded.shape[0]
    ids = _h2d(padded[None].astype(np.int64), device)
    positions = (fill + torch.arange(w, device=device))[None]
    last = torch.full((1,), true_len - 1, dtype=torch.long, device=device)
    return model(ids, positions=positions, cache=cache, last_index=last)[:, 0]


def _set_lanes(state: SlotState, slot_idx, samplings: List[tuple]) -> None:
    """Sampling lanes of the admitted slots (``slot_idx`` an index
    tensor or a slice): temperature, top-p, the seed key, and the step
    counter reset to 0."""
    device = state.temps.device
    state.temps[slot_idx] = _h2d(
        np.array([s[0] for s in samplings], np.float32), device)
    state.topps[slot_idx] = _h2d(
        np.array([s[1] for s in samplings], np.float32), device)
    state.keys[slot_idx] = _h2d(
        np.array([_seed_key(s[2]) for s in samplings], np.int64), device)
    state.draws[slot_idx] = 0


def _insert_slots_batch_paged(state: SlotState, caches: DenseCache,
                              logits: torch.Tensor, slots: List[int],
                              fills: np.ndarray, pages_b: np.ndarray,
                              samplings: List[tuple], n_rows: int) -> None:
    """Scatter every admitted row's first ``n_rows`` prefill rows (the
    padded bucket) into its allocated pages, point its block-table row
    at them, and set its fill level, carried logits, live flag and
    sampling lane."""
    kv = state.cache
    device = logits.device
    ps = kv.page_size
    nc = n_rows // ps
    k_rows = len(slots)
    idx = _h2d(np.ascontiguousarray(pages_b[:, :nc]).reshape(-1), device)
    for layer in range(len(caches.k)):
        def chunks(t):
            rows = t[:, :n_rows]
            return rows.reshape((k_rows * nc, ps) + tuple(rows.shape[2:]))
        scales = ((chunks(caches.k_scale[layer]),
                   chunks(caches.v_scale[layer]))
                  if caches.k_scale is not None else (None, None))
        kv.write_pages(layer, idx, chunks(caches.k[layer]),
                       chunks(caches.v[layer]), *scales)
    slot_idx = _h2d(np.asarray(slots, np.int64), device)
    kv.block_table[slot_idx] = _h2d(pages_b, device)
    state.positions[slot_idx] = _h2d(fills.astype(np.int64), device)
    state.last_logits[slot_idx] = logits
    state.live[slot_idx] = True
    _set_lanes(state, slot_idx, samplings)


def _paged_prefill_chunk(model: CausalLM, state: SlotState,
                         padded: np.ndarray, fill: int, true_len: int,
                         row: np.ndarray) -> torch.Tensor:
    """One chunked-prefill piece written STRAIGHT into the page pool: a
    batch-1 multi-token slot-decode forward at positions ``fill +
    arange(w)`` whose cache view shares the pool's pages but reads and
    writes through ``row`` (the admission's sentinel-padded page row)
    instead of the block table. The slot's own table row stays at the
    sentinel until activation, so interleaved decode chunks' dead-row
    writes for the reserved slot go to the trash page. Pad rows past the
    piece's ``true_len`` real tokens land in pages the admission owns (or
    the trash) and are overwritten by the next piece or by decode.
    Returns the logits at the piece's last REAL token ``[1, V]``."""
    if not isinstance(state.cache, PagedKV):
        raise ValueError(
            "prefill_chunk writes into the paged pool; dense engines run "
            "chunked prefill through _extend_prefix")
    view = state.cache.with_table(_h2d(row[None], model.device))
    return _extend_prefix(model, view, padded, fill, true_len)


def _activate_slot_paged(state: SlotState, slot: int, row: np.ndarray,
                         fill: int, logits1: torch.Tensor,
                         sampling: tuple) -> None:
    """Chunked-prefill admission complete: point the slot's block-table
    row at the admission's pages (every piece already lives in them) and
    flip the slot live with its fill level, carried logits and sampling
    lane — no cache rows to move."""
    state.cache.block_table[slot] = _h2d(row, logits1.device)
    state.positions[slot] = fill
    state.last_logits[slot] = logits1[0]
    state.live[slot] = True
    _set_lanes(state, slice(slot, slot + 1), [sampling])


def _insert_slots_batch(state: SlotState, caches: DenseCache,
                        logits: torch.Tensor, slots: List[int],
                        fills: np.ndarray, samplings: List[tuple]) -> None:
    """Dense admission: copy each prefilled row (``caches [k, w]``, ``w``
    a bucket or the whole context) into the first ``w`` rows of its slot
    and set the slot's fill level, carried logits, live flag and
    sampling lane. The slot's rows past ``w`` keep an earlier request's
    values, masked by position until the slot's own writes reach them
    (the JAX insert copies zeros there: both mask to the same 0)."""
    dc = state.cache
    w = caches.k[0].shape[1]
    device = logits.device
    slot_idx = _h2d(np.asarray(slots, np.int64), device)
    for layer in range(len(dc.k)):
        dc.k[layer][slot_idx, :w] = caches.k[layer]
        dc.v[layer][slot_idx, :w] = caches.v[layer]
        if dc.k_scale is not None:
            dc.k_scale[layer][slot_idx, :w] = caches.k_scale[layer]
            dc.v_scale[layer][slot_idx, :w] = caches.v_scale[layer]
    state.positions[slot_idx] = _h2d(np.asarray(fills, np.int64), device)
    state.last_logits[slot_idx] = logits
    state.live[slot_idx] = True
    _set_lanes(state, slot_idx, samplings)


def _clear_live(state: SlotState, slot: int) -> None:
    """Dense free: drop the live flag (the slot's rows are rewritten by
    its next admission)."""
    state.live[slot] = False


def _clear_live_paged(state: SlotState, slot: int) -> None:
    """Paged free: drop the live flag AND reset the slot's block-table
    row to the sentinel, so in-flight dead-row replays write to the trash
    page instead of pages the engine is about to hand to another
    request."""
    state.cache.block_table[slot] = state.cache.num_pages
    state.live[slot] = False


def _pick_tokens(logits: torch.Tensor, state: SlotState, sampling: bool,
                 stream: int = lanes.PICK) -> torch.Tensor:
    """[B] next tokens: greedy rows argmax; with ``sampling`` every row's
    temperature-scaled, top-p-filtered draw (noise of ``stream``) is
    computed and the rows with a temperature take it."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    scaled = logits / state.temps.clamp_min(1e-6)[:, None]
    filtered = _filter_logits(scaled, None, state.topps[:, None])
    sampled = torch.argmax(filtered + _gumbel(state, stream), dim=-1)
    return torch.where(state.temps > 0, sampled, greedy)


def _decode_chunk(model: CausalLM, state: SlotState, size: int,
                  eos_token_id: Optional[int], pad_id: int,
                  sampling: bool) -> torch.Tensor:
    """``size`` decode steps for ALL slots; returns the emitted tokens
    ``[B, size]`` and updates ``state`` in place (the body a CUDA graph
    captures)."""
    emitted_steps = []
    for _ in range(size):
        tok = _pick_tokens(state.last_logits, state, sampling)
        live = state.live
        # emit BEFORE the eos latch drops `live`: the eos token itself
        # belongs to the output
        emitted_steps.append(torch.where(live, tok, pad_id))
        if eos_token_id is not None:
            live = live & (tok != eos_token_id)
        # dead rows replay their FROZEN position with a pad token: one
        # past the row's last real token, inside its own pages and past
        # the extent the prefix cache adopts (never a shared page)
        step_tok = torch.where(live, tok, pad_id)
        logits = model(step_tok[:, None], positions=state.positions[:, None],
                       cache=state.cache, inloop=True)
        state.positions.add_(live.long())
        state.last_logits.copy_(logits[:, 0])
        state.live.copy_(live)
        if sampling:
            state.draws.add_(1)
    return torch.stack(emitted_steps, dim=1)


# -- speculative decoding in the slots (draft/verify) ---------------------------
#
# Per slot, a cheap DRAFT model (a small companion model, or the target
# itself — "self-draft" — when none is given) proposes ``spec_tokens``
# tokens, then ONE (k+1)-wide verify forward of the target scores them
# through the same paged slot-decode path chunked prefill uses (K1's
# chunk entry). Accepted tokens advance each slot's position; rejected
# ones roll back by not advancing it — the rows past the position are
# masked and overwritten by the next round. The acceptance rule lives in
# ``models/speculative.py``, shared with the standalone driver.
#
# The draft runs a DENSE slot cache of its own (``[num_slots,
# draft_max_seq, ...]``, sharing the target's per-slot positions):
# drafts are cheap and transient, and their contents never affect
# correctness — a cold draft row only proposes tokens the verify
# rejects. The draft cache has no fill state of its own (the positions
# are the target's), so a capture's warm-up needs nothing of it put
# back: its draft writes land at and past each row's position, where
# the first replay writes again before any row reads them.


class DraftSlots:
    """The draft half of the slot pool (``_draft_zeros_cache``): the
    draft model and its dense ``[num_slots, max_seq_len]`` cache,
    allocated once and written in place by index, so a captured spec
    chunk replays over it."""

    def __init__(self, model: CausalLM, num_slots: int,
                 device: torch.device):
        self.model = model
        self.cache = DenseCache(model.cfg, num_slots, model.cfg.max_seq_len,
                                device, model.kv_cache_heads)


def _insert_draft_rows(draft: DraftSlots, caches: DenseCache,
                       slots: List[int]) -> None:
    """``_insert_draft_rows_batch``: drop the rows of a batched draft
    prefill (``[len(slots), w]``) into the draft rows of ``slots``, by
    index through pinned host buffers. Rows past ``w`` keep stale values
    past the prompt, masked until a round writes them."""
    dc = draft.cache
    w = caches.k[0].shape[1]
    idx = _h2d(np.asarray(slots, np.int64), dc.k[0].device)
    for layer in range(len(dc.k)):
        dc.k[layer][idx, :w] = caches.k[layer]
        dc.v[layer][idx, :w] = caches.v[layer]
        if dc.k_scale is not None:
            dc.k_scale[layer][idx, :w] = caches.k_scale[layer]
            dc.v_scale[layer][idx, :w] = caches.v_scale[layer]


def _draft_prefill_rows(draft: DraftSlots, padded: np.ndarray,
                        true_lens: np.ndarray, slots: List[int]) -> None:
    """``draft_prefill_rows_batch``: one right-padded draft prefill of
    ``padded [k, w]`` into the draft rows of ``slots``."""
    caches, _ = _prefill_padded_batch(draft.model, padded, true_lens)
    _insert_draft_rows(draft, caches, slots)


def _spec_chunk(model: CausalLM, draft: DraftSlots, state: SlotState,
                rounds: int, k: int, eos_token_id: Optional[int],
                pad_id: int, sampling: bool) -> torch.Tensor:
    """``rounds`` draft/verify rounds for ALL slots — the spec
    counterpart of :func:`_decode_chunk`, updating ``state`` and the
    draft cache in place (the body a CUDA graph captures).

    Entry emits one token from the carried logits (a plain step's emit)
    as the first PENDING token. Each round runs k single-token draft
    forwards proposing d_1..d_k from the pending token, feeds d_k too
    (its K/V a fully accepted round needs next), then ONE (k+1)-wide
    verify forward of the target over [pending, d_1..d_k] at positions
    fill..fill+k; :func:`accept_and_correct` gives the accepted length
    and the correction, the round emits [d_1..d_a, correction] (eos in
    the window truncates it and drops the live flag, as the plain
    chunk's emit-then-latch order), and the position advances by exactly
    the emitted count — the rollback. Exit feeds the final pending token
    through target and draft, so ``last_logits`` / ``positions`` leave in
    the plain chunk's invariant.

    Returns the packed int32 ``[rounds·(k+1) + 3·rounds + 2, B]``: the
    rounds' emission windows, their valid lengths, the accepted and
    proposed counts, the entry tokens and the final live flags
    (:func:`_unpack_spec` is the host-side inverse)."""
    b = state.live.shape[0]
    width = k + 1
    iota_w = torch.arange(width, device=state.positions.device)
    dmodel, dcache = draft.model, draft.cache
    # entry: emit one token from the carried logits (the eos token itself
    # belongs to the output)
    t0 = _pick_tokens(state.last_logits, state, sampling)
    if sampling:
        state.draws.add_(1)
    entry_tok = torch.where(state.live, t0, pad_id)
    live = state.live
    if eos_token_id is not None:
        live = live & (t0 != eos_token_id)
    pending = torch.where(live, t0, pad_id)
    positions = state.positions
    windows, wlens, accepted, proposed = [], [], [], []
    for _ in range(rounds):
        # 1. draft: k single-token forwards from the pending token
        cur, dtoks, dlogits = pending, [], []
        for j in range(k):
            feed = torch.where(live, cur, pad_id)
            lg = dmodel(feed[:, None], positions=(positions + j)[:, None],
                        cache=dcache, inloop=True)[:, 0]
            cur = _pick_tokens(lg, state, sampling, lanes.DRAFT)
            if sampling:
                state.draws.add_(1)
            dtoks.append(cur)
            dlogits.append(lg)
        # feed the final proposal too (cache rows only)
        dmodel(torch.where(live, cur, pad_id)[:, None],
               positions=(positions + k)[:, None], cache=dcache,
               return_hidden=True, inloop=True)
        drafts = torch.stack(dtoks, dim=1)                  # [B, k]
        # 2. verify: ONE (k+1)-wide chunk forward writes K/V for
        #    [pending, d_1..d_k] at fill..fill+k and scores every position
        #    (dead rows feed pad at their frozen position: their writes
        #    go through the sentinel to the trash page, or past the fill)
        vchunk = torch.where(live[:, None],
                             torch.cat([pending[:, None], drafts], dim=1),
                             pad_id)
        logits_v = model(vchunk, positions=positions[:, None] + iota_w,
                         cache=state.cache, inloop=True)
        # 3. accept + correct (THE shared rule)
        if sampling:
            a, correction = accept_and_correct(
                drafts, torch.stack(dlogits, dim=1), logits_v,
                temps=state.temps, topps=state.topps, keys=state.keys,
                draws=state.draws)
            state.draws.add_(1)
        else:
            a, correction = accept_and_correct(
                drafts, torch.stack(dlogits, dim=1), logits_v)
        # 4. emit window + eos latch + position advance (= rollback)
        window = emit_window(drafts, correction, a)         # [B, k+1]
        if eos_token_id is not None:
            is_eos = (window == eos_token_id) & (iota_w <= a[:, None])
            any_eos = is_eos.any(dim=1)
            eos_idx = torch.argmax(is_eos.long(), dim=1)    # the first
            vlen = torch.where(any_eos, eos_idx + 1, a + 1)
            new_live = live & ~any_eos
        else:
            vlen = a + 1
            new_live = live
        vlen = torch.where(live, vlen, 0)
        windows.append(torch.where(iota_w < vlen[:, None], window, pad_id))
        wlens.append(vlen)
        accepted.append(torch.where(live, a, 0))
        proposed.append(live.long() * k)
        # rows fed and valid this round = pending + the accepted drafts
        # before any eos: exactly the emitted count
        positions = positions + vlen
        pending = torch.where(new_live, correction, pad_id)
        live = new_live
    # exit: feed the final pending token through target AND draft
    step_tok = torch.where(live, pending, pad_id)
    logits = model(step_tok[:, None], positions=positions[:, None],
                   cache=state.cache, inloop=True)
    dmodel(step_tok[:, None], positions=positions[:, None], cache=dcache,
           return_hidden=True, inloop=True)
    state.positions.copy_(positions + live.long())
    state.last_logits.copy_(logits[:, 0])
    state.live.copy_(live)
    return torch.cat([
        torch.stack(windows).transpose(1, 2).reshape(rounds * width, b),
        torch.stack(wlens), torch.stack(accepted), torch.stack(proposed),
        entry_tok[None], live.long()[None]], dim=0).to(torch.int32)


def _unpack_spec(packed: np.ndarray, k: int):
    """Host-side inverse of :func:`_spec_chunk`'s packed output:
    ``(entry_tok [B], windows [rounds, k+1, B], wlens [rounds, B],
    accepted [rounds, B], proposed [rounds, B], live [B] bool)``."""
    width = k + 1
    rounds = (packed.shape[0] - 2) // (width + 3)
    wrows = rounds * width
    windows = packed[:wrows].reshape(rounds, width, -1)
    wlens = packed[wrows:wrows + rounds]
    accepted = packed[wrows + rounds:wrows + 2 * rounds]
    proposed = packed[wrows + 2 * rounds:wrows + 3 * rounds]
    return (packed[-2], windows, wlens, accepted, proposed,
            packed[-1] > 0)


class _InflightStep:
    """One dispatched-but-unsettled chunk (or admission): its ``kind``
    (``"dev"`` a decode chunk, ``"spec_dev"`` a spec chunk, ``"admit"``),
    the result handles (pinned host buffers filled behind ``event``: a
    decode chunk's tokens and live flags, a spec chunk's packed array),
    the slot->request SNAPSHOT the chunk was computed over (scheduling
    for the next step mutates ``engine._slots`` freely; the settle walks
    the snapshot), and the dispatch/retire timestamps that feed the
    device-busy interval derivation (``obs/stepstats.py``).
    ``t_dispatch`` is stamped at ENTRY to the dispatch call; ``t_retire``
    at the first moment the event was observed complete (a
    non-blocking ``poll_ready`` at a step's top or tail, or the fetch
    return). ``event`` is None on the CPU, where work is synchronous."""

    __slots__ = ("kind", "a", "b", "event", "snapshot", "size",
                 "t_dispatch", "t_retire")

    def __init__(self, kind, a, b, event, snapshot, size, t_dispatch):
        self.kind = kind
        self.a = a                  # tokens [B, size], or the packed array
        self.b = b                  # live flags [B] (decode chunks)
        self.event = event
        self.snapshot = snapshot    # slot -> _Request at dispatch
        self.size = size            # max tokens emitted per slot
        self.t_dispatch = float(t_dispatch)
        self.t_retire: Optional[float] = None

    def poll_ready(self) -> bool:
        """Non-blocking: has the device finished this work?"""
        return self.event is None or self.event.query()

    def fetch(self):
        """``(a, b)`` as numpy (``b`` None for a spec chunk), waiting for
        the event."""
        if self.event is not None:
            self.event.synchronize()
        return (self.a.numpy(),
                self.b.numpy() if self.b is not None else None)


# -- the device half ------------------------------------------------------------

# a greedy lane (temperature 0): what the wire gives a slot whose request
# does not sample
_GREEDY = (0.0, 1.0, 0)


def wire_sampling(req: _Request) -> tuple:
    """The lane a request's admission installs, as every rank receives it
    (``announce_cb_admit`` sends a lane only when it samples): its
    ``(temperature, top_p, seed)``, or the greedy lane."""
    if req.temperature > 0:
        return req.sampling()
    return _GREEDY


def _chunk_captured(model: CausalLM, device: torch.device) -> bool:
    """Whether a chunk on ``device`` is captured as a CUDA graph: on
    CUDA, unless the model's tp group is not NCCL's (gloo's collectives
    cannot be captured; the chunk then runs eagerly). Decided once, from
    the group's backend; a failed capture is never caught."""
    if device.type != "cuda":
        return False
    tp = model.spmd.tp if model.spmd is not None else None
    if tp is None:
        return True
    import torch.distributed as dist

    return dist.get_backend(tp.group) == "nccl"


class SlotDeviceState:
    """The engine's DEVICE half (the JAX ``SlotDeviceState``): the slot
    state (:class:`SlotState`), the draft's slots, the captured chunks
    and every op that changes them — admit (batched or one request),
    chunked-prefill piece, slot activation, copy-on-write page clone,
    draft rows, decode and spec chunks (immediate or deferred), collect,
    free and the KV page reads and installs. Process 0's engine and a
    worker's replica (``train/serving.serve_worker_loop``) call the same
    code with the same inputs in the same order, so on a tp mesh every
    rank issues the same device collectives and holds the same fills,
    block tables and carried logits.

    ``draft_model`` is the draft of speculative chunks; without one
    (``spec_tokens > 0``, or the first spec op a worker replays) the
    target drafts for itself. ``captured`` says whether chunks replay
    CUDA graphs (:func:`_chunk_captured`)."""

    def __init__(self, model: CausalLM, num_slots: int,
                 draft_model: Optional[CausalLM] = None,
                 spec_tokens: int = 0):
        self.model = model
        self.num_slots = num_slots
        self.device = model.device
        self.paged = model.cfg.paged_kv
        self.state = SlotState(model, num_slots, self.device)
        self.spec_tokens = int(spec_tokens)
        self._draft_model = draft_model
        self.draft: Optional[DraftSlots] = None
        if draft_model is not None or self.spec_tokens:
            self._ensure_draft()
        self.captured = _chunk_captured(model, self.device)
        # the captured chunks, decode by (size, sampling), spec by
        # (rounds, k, sampling)
        self.graphs: Dict[tuple, graphs.Captured] = {}
        self._graph_pool = None

    def _ensure_draft(self) -> DraftSlots:
        if self.draft is None:
            draft = (self._draft_model if self._draft_model is not None
                     else self.model)
            if draft.device != self.device:
                raise ValueError(f"draft model on {draft.device}, target on "
                                 f"{self.device}: one device for both")
            self.draft = DraftSlots(draft, self.num_slots, self.device)
        return self.draft

    # -- admission -------------------------------------------------------
    @torch.no_grad()
    def admit(self, padded: np.ndarray, lens: np.ndarray, slots: List[int],
              samplings: List[tuple],
              pages_b: Optional[np.ndarray] = None) -> None:
        """ONE prefill of the right-padded prompts ``padded [k, w]`` and
        ONE scatter of them into ``slots`` (a paged model's into the
        pages of each row of ``pages_b``), with each slot's fill, carried
        logits, live flag and sampling lane."""
        caches, logits = _prefill_padded_batch(self.model, padded, lens)
        if self.paged:
            _insert_slots_batch_paged(self.state, caches, logits, slots,
                                      lens, pages_b, samplings,
                                      n_rows=padded.shape[1])
        else:
            _insert_slots_batch(self.state, caches, logits, slots, lens,
                                samplings)

    def admit_padded(self, padded: np.ndarray, true_len: int, slot: int,
                     sampling: Optional[tuple] = None,
                     pages: Optional[np.ndarray] = None) -> None:
        """One request's admission (the wire's ``OP_CB_ADMIT``):
        ``padded [1, w]`` into ``slot`` (a paged model's into the pages of
        ``pages``), its lane ``sampling`` (greedy when None)."""
        self.admit(np.asarray(padded, np.int32).reshape(1, -1),
                   np.asarray([true_len], np.int32), [slot],
                   [sampling if sampling is not None else _GREEDY],
                   None if pages is None
                   else np.asarray(pages, np.int32)[None])

    @torch.no_grad()
    def draft_prefill_rows(self, padded: np.ndarray, lens: np.ndarray,
                           slots: List[int]) -> None:
        """The draft's half of an admission: one right-padded draft
        prefill of ``padded [k, w]`` into the draft rows of ``slots``."""
        _draft_prefill_rows(self._ensure_draft(), padded,
                            np.asarray(lens, np.int32), list(slots))

    def draft_prefill_row(self, padded: np.ndarray, true_len: int,
                          slot: int) -> None:
        """One request's draft prefill (``padded [1, w]``) into the draft
        row of ``slot``."""
        self.draft_prefill_rows(np.asarray(padded, np.int32).reshape(1, -1),
                                np.asarray([true_len], np.int32), [slot])

    @torch.no_grad()
    def prefill_chunk(self, padded: np.ndarray, fill: int, true_len: int,
                      row: np.ndarray) -> torch.Tensor:
        """One chunked-prefill piece (``padded [w]`` or ``[1, w]``)
        straight into the page pool through ``row``
        (:func:`_paged_prefill_chunk`); its last real token's logits
        ``[1, V]``."""
        return _paged_prefill_chunk(self.model, self.state,
                                    np.asarray(padded, np.int32).reshape(-1),
                                    fill, true_len,
                                    np.asarray(row, np.int32))

    @torch.no_grad()
    def activate_slot(self, slot: int, fill: int, logits1: torch.Tensor,
                      row: np.ndarray, sampling: tuple) -> None:
        _activate_slot_paged(self.state, slot, row, fill, logits1, sampling)

    @torch.no_grad()
    def copy_page(self, src: int, dst: int) -> None:
        self.state.cache.copy_page(src, dst)

    @torch.no_grad()
    def free(self, slot: int) -> None:
        if self.paged:
            _clear_live_paged(self.state, slot)
        else:
            _clear_live(self.state, slot)

    # -- KV pages ----------------------------------------------------------
    @torch.no_grad()
    def read_pages(self, pages) -> List[dict]:
        """``_gather_pages``: the rows of ``pages`` from every layer's
        pool leaves, host numpy, one dict per layer in wire order (bf16
        as float32). On a tp mesh every rank calls it: the ranks' heads
        are gathered, so the rows hold every KV head, as one process's
        do."""
        if not self.paged:
            raise ValueError("read_pages needs the paged cache layout")
        kv = self.state.cache
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        out = []
        for layer in wire_layer_order(self.model.cfg.num_layers):
            rec = {}
            for key, leaf in kv.page_leaves(layer).items():
                rows = _all_heads(self.model, leaf[idx])
                if rows.dtype == torch.bfloat16:
                    rows = rows.float()  # numpy has no bfloat16
                rec[key] = rows.cpu().numpy()
            out.append(rec)
        return out

    @torch.no_grad()
    def write_pages(self, pages, blobs) -> None:
        """``_install_pages``: scatter transferred page rows (one dict a
        layer, wire order, every KV head) into the pool at ``pages``,
        cast to each leaf's dtype; a tp rank installs its own heads."""
        if not self.paged:
            raise ValueError("write_pages needs the paged cache layout")
        kv = self.state.cache
        idx = _h2d(np.asarray(pages, np.int64), self.device)
        heads = self.model.kv_heads_held
        for layer, rec in zip(wire_layer_order(self.model.cfg.num_layers),
                              blobs):
            for key, leaf in kv.page_leaves(layer).items():
                if key not in rec:
                    raise ValueError(f"KV transfer lacks {key} for "
                                     f"layer {layer}")
                rows = np.asarray(rec[key])
                if rows.dtype.kind not in "iuf":
                    rows = rows.astype(np.float32)  # bfloat16 arrays
                if rows.ndim >= 3 and rows.shape[2] == self.model.cfg.kv_heads:
                    rows = rows[:, :, heads]
                if rows.shape[1:] != leaf.shape[1:]:
                    raise ValueError(
                        f"KV transfer {key} rows {rows.shape[1:]} do "
                        f"not fit pages {tuple(leaf.shape[1:])}")
                leaf[idx] = _h2d(rows, self.device).to(leaf.dtype)

    # -- chunks --------------------------------------------------------------
    def _chunk_body(self, key: tuple, eos_token_id: Optional[int],
                    pad_id: int):
        """The chunk body of a graph key: a decode chunk for ``(size,
        sampling)``, a spec chunk for ``(rounds, k, sampling)``."""
        st = self.state
        if len(key) == 3:
            rounds, k, sampling = key
            draft = self._ensure_draft()
            return lambda: _spec_chunk(self.model, draft, st, rounds, k,
                                       eos_token_id, pad_id, sampling)
        size, sampling = key
        return lambda: _decode_chunk(self.model, st, size, eos_token_id,
                                     pad_id, sampling)

    def _graph(self, key: tuple, eos_token_id: Optional[int],
               pad_id: int) -> graphs.Captured:
        """The captured chunk of ``key``, captured on first use
        (``ops/graphs.py``: an eager warm-up on a side stream, the
        carried slot state put back, then the capture into the shared
        pool). The warm-up's page and draft writes land where the first
        replay writes the same values: at and past each row's position,
        in its own pages, the trash page or its draft row. A failed
        capture raises; nothing falls back to eager launches."""
        entry = self.graphs.get(key)
        if entry is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            entry = graphs.capture(self._chunk_body(key, eos_token_id,
                                                    pad_id),
                                   self.state.carried(), self.device,
                                   self._graph_pool)
            self.graphs[key] = entry
        return entry

    def _run(self, key: tuple, eos_token_id: Optional[int], pad_id: int,
             extra: Sequence[torch.Tensor]):
        """Run one chunk without reading it back: ``(outputs, event)``,
        its output and ``extra`` copied into fresh pinned host buffers
        behind ``event`` on CUDA (the graph replayed when ``captured``,
        the body launched eagerly otherwise); the CPU runs the body and
        ``event`` is None."""
        if self.device.type != "cuda":
            out = self._chunk_body(key, eos_token_id, pad_id)()
            return [out] + [t.clone() for t in extra], None
        if self.captured:
            entry = self._graph(key, eos_token_id, pad_id)
            entry.replay()
            out = entry.out
        else:
            out = self._chunk_body(key, eos_token_id, pad_id)()
        return graphs.pinned_copies([out] + list(extra), self.device)

    @torch.no_grad()
    def chunk_async(self, size: int, eos_token_id: Optional[int],
                    pad_id: int, sampling: bool = False):
        """Dispatch one ``size``-step decode chunk over every slot:
        ``(tokens [B, size], live [B], event)``."""
        (toks, live), event = self._run((size, sampling), eos_token_id,
                                        pad_id, [self.state.live])
        return toks, live, event

    @torch.no_grad()
    def spec_chunk_async(self, rounds: int, eos_token_id: Optional[int],
                         pad_id: int, sampling: bool = False,
                         k: Optional[int] = None):
        """Dispatch one ``rounds``-round spec chunk of width ``k`` (the
        construction's ``spec_tokens`` when None: a worker learns it from
        each chunk header): ``(packed, event)``."""
        key = (rounds, int(k) if k is not None else self.spec_tokens,
               sampling)
        (packed,), event = self._run(key, eos_token_id, pad_id, [])
        return packed, event

    @staticmethod
    def fetch(*arrays, event=None) -> tuple:
        """A dispatched chunk's results as numpy, waiting for ``event``."""
        if event is not None:
            event.synchronize()
        return tuple(a.numpy() if a is not None else None for a in arrays)

    def fetch_tuple(self, handles) -> tuple:
        """:meth:`fetch` of what :meth:`chunk_async` or
        :meth:`spec_chunk_async` returned."""
        *arrays, event = handles
        return self.fetch(*arrays, event=event)

    def chunk(self, size: int, eos_token_id: Optional[int], pad_id: int,
              sampling: bool = False) -> tuple:
        """Dispatch and read back (the unpipelined path): ``(tokens,
        live)`` as numpy."""
        toks, live, event = self.chunk_async(size, eos_token_id, pad_id,
                                             sampling)
        return self.fetch(toks, live, event=event)

    def spec_chunk(self, rounds: int, eos_token_id: Optional[int],
                   pad_id: int, sampling: bool = False,
                   k: Optional[int] = None) -> np.ndarray:
        packed, event = self.spec_chunk_async(rounds, eos_token_id, pad_id,
                                              sampling, k)
        return self.fetch(packed, event=event)[0]


def _all_heads(model: CausalLM, rows: torch.Tensor) -> torch.Tensor:
    """Page rows ``[n, P, h, ...]`` of a rank's KV heads as rows of every
    KV head (one process's layout): gathered over the model's tp group
    (a collective) and each global head taken from the first rank that
    holds it. The rows themselves off a tp mesh."""
    tp = model.spmd.tp if model.spmd is not None else None
    if tp is None:
        return rows
    from pyspark_tf_gke_tpu_torch.parallel.spmd import all_gather_cat

    cfg = model.cfg
    held = [kv_heads_of(cfg, tp.size, r) for r in range(tp.size)]
    both = all_gather_cat(rows.contiguous(), 2, tp.group, tp.order)
    pick = []
    for head in range(cfg.kv_heads):
        for r, heads in enumerate(held):
            if head in heads:
                pick.append(r * len(heads) + heads.index(head))
                break
    return both[:, :, pick]


# -- the radix prefix cache (host side) -----------------------------------------


class PrefixCache:
    """The dense engine's prefix cache: an LRU of prefilled prompt
    PREFIXES (the shared-system-prompt pattern), each a batch-1 ``[1,
    max_seq_len]`` staging cache and the logits at its fill level (the
    JAX engine's ``PrefixCache``). ``lookup`` returns the entry with the
    longest common token prefix; admission copies it into the slot and
    only the remainder pays prefill compute. Each entry costs one slot's
    worth of KV memory. An admission that extends an entry extends a
    clone: the entry itself is never written."""

    def __init__(self, capacity: int = 4):
        if capacity < 1:
            raise ValueError("prefix cache capacity must be >= 1")
        self.capacity = capacity
        self._entries: Dict[tuple, tuple] = {}  # key -> (cache1, logits1)
        self._order: List[tuple] = []  # LRU, most recent last
        self.hits = self.misses = 0

    def put(self, key_tokens, cache1: DenseCache,
            logits1: torch.Tensor) -> None:
        key = tuple(int(t) for t in key_tokens)
        if key in self._entries:
            self._order.remove(key)
        elif len(self._entries) >= self.capacity:
            del self._entries[self._order.pop(0)]
        self._entries[key] = (cache1, logits1)
        self._order.append(key)

    def lookup(self, prompt, peek: bool = False):
        """The entry with the LONGEST COMMON TOKEN PREFIX with ``prompt``
        (BPE tokenizers are not prefix-stable: a warmed prefix and a
        prompt can diverge one token early, and every row before the
        divergence is reused). ``(usable_fill, cache1, logits1 or
        None)`` or None; ``logits1`` only when the whole entry is the
        whole prompt. A prompt that is a STRICT prefix of an entry would
        need logits at a fill level the entry does not store: declined.
        ``peek`` leaves the stats and the LRU order alone."""
        toks = np.asarray(prompt, np.int64)
        best, best_common = None, 0
        for key in self._entries:
            k = np.asarray(key, np.int64)
            n = min(k.size, toks.size)
            neq = np.nonzero(k[:n] != toks[:n])[0]
            common = int(neq[0]) if neq.size else n
            if common > best_common:
                best, best_common = key, common
        if best is None or best_common == 0 or (
                best_common == toks.size and best_common != len(best)):
            if not peek:
                self.misses += 1
            return None
        if not peek:
            self.hits += 1
            self._order.remove(best)
            self._order.append(best)
        cache1, logits1 = self._entries[best]
        exact = best_common == len(best) == toks.size
        return best_common, cache1, (logits1 if exact else None)

    @property
    def stats(self) -> dict:
        return {"entries": len(self._entries), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses}


class _RadixNode:
    """One KV page in the radix prefix cache: ``tokens`` is the page's
    token content (``page_size`` long for interior/full pages, shorter
    for a TAIL page holding a partially-filled final page — always a
    leaf). Children are keyed by their token tuple, but LOOKUP scans
    children for the longest common prefix rather than dict-probing:
    two siblings may share an in-page prefix after divergent inserts
    ("efgh" and "efxy"), and a tail node matches any prompt that
    extends its tokens."""

    __slots__ = ("tokens", "page", "children", "parent", "last_used")

    def __init__(self, tokens: tuple, page: Optional[int], parent):
        self.tokens = tokens
        self.page = page
        self.parent = parent
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Trie index over the PAGED KV pool (the engine owns the pages;
    this class owns only the token->page index): completed prompts'
    pages stay resident, a new prompt matches its longest cached prefix
    at page granularity and SHARES those pages copy-on-write, so prefill
    compute and pool traffic are proportional to the unique suffix only.

    The trie never touches device state or refcounts: ``match`` /
    ``insert`` / ``evict`` return page-id lists and the ENGINE moves the
    refcounts (+1 for every page the trie adopts, -1 for every page it
    releases). Eviction is LRU over leaf nodes whose page has no slot
    reference (``busy`` predicate), leaf-first so a cached path is
    always contiguous from the root."""

    def __init__(self, page_size: int, capacity_pages: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        self.page_size = int(page_size)
        self.capacity = int(capacity_pages)
        self._root = _RadixNode((), None, None)
        self._tick = 0
        self.resident_pages = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        # last-N admission outcomes: the windowed hit rate tracks what
        # the cache absorbs NOW, not its lifetime ratio
        self._recent: Deque[int] = deque(maxlen=64)

    @staticmethod
    def _common(a, b) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _touch(self, node: _RadixNode) -> None:
        # the whole matched path was used: eviction is leaf-only, but a
        # deep leaf must keep its ancestors young for when IT is evicted
        self._tick += 1
        while node is not None and node.page is not None:
            node.last_used = self._tick
            node = node.parent

    def match(self, prompt, limit: Optional[int] = None,
              peek: bool = False, count: bool = True):
        """Longest cached prefix of ``prompt``: ``(matched_tokens,
        full_page_ids, cow)`` where ``cow`` is ``(src_page, rows)`` when
        the match ends INSIDE a page (the admission clones those rows
        into a fresh page before its suffix appends there). ``limit``
        caps the match — default ``len(prompt) - 1``: at least one
        suffix token must be computed for the carried logits. ``peek``
        skips stats and LRU touching; ``count=False`` touches the LRU
        but leaves the hit/miss stats to an explicit :meth:`note`."""
        toks = tuple(int(t) for t in prompt)
        limit = len(toks) - 1 if limit is None else min(limit, len(toks))
        node = self._root
        t = 0
        pages: List[int] = []
        cow = None
        last = None
        while t < limit:
            rem = toks[t:]
            best, best_c = None, 0
            for child in node.children.values():
                c = self._common(child.tokens, rem)
                if c > best_c:
                    best, best_c = child, c
            if best is None:
                break
            best_c = min(best_c, limit - t)
            if best_c <= 0:
                break
            last = best
            if best_c == len(best.tokens) == self.page_size:
                pages.append(best.page)
                t += self.page_size
                node = best
                continue
            # partial in-page match: a tail node, a mid-page divergence,
            # or the limit cap — the walk ends here
            cow = (best.page, best_c)
            t += best_c
            break
        if not peek:
            if last is not None:
                self._touch(last)
            if count:
                self.note(t)
        return t, pages, cow

    def note(self, matched: int) -> None:
        """Record one ADMISSION outcome."""
        if matched > 0:
            self.hits += 1
            self.hit_tokens += int(matched)
            self._recent.append(1)
        else:
            self.misses += 1
            self._recent.append(0)

    @property
    def recent_hit_rate(self) -> float:
        """Hit rate over the last up-to-64 admissions."""
        if not self._recent:
            return 0.0
        return sum(self._recent) / len(self._recent)

    def insert(self, tokens, pages):
        """Index ``tokens`` (chunked per page) over their physical
        ``pages`` (block-table row order). Chunks an existing node
        already covers are NOT re-adopted; a partial tail node that is a
        strict prefix of a longer chunk is UPGRADED in place to the new,
        fuller page. Returns ``(adopted, released)`` page-id lists for
        the engine's refcount moves."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        adopted: List[int] = []
        released: List[int] = []
        node = self._root
        self._tick += 1
        for i in range(0, len(toks), ps):
            chunk = toks[i:i + ps]
            page = int(pages[i // ps])
            nxt = None
            for child in node.children.values():
                c = self._common(child.tokens, chunk)
                if c == len(chunk) and len(child.tokens) >= len(chunk):
                    nxt = child  # already covered (possibly by a
                    break        # longer tail) — keep the cached page
                if c == len(child.tokens) and c < len(chunk):
                    # the cached tail is a strict prefix of our chunk:
                    # upgrade the node to the fuller page
                    del node.children[child.tokens]
                    released.append(child.page)
                    child.tokens = chunk
                    child.page = page
                    node.children[chunk] = child
                    adopted.append(page)
                    nxt = child
                    break
            if nxt is None:
                nxt = _RadixNode(chunk, page, node)
                node.children[chunk] = nxt
                adopted.append(page)
                self.resident_pages += 1
            nxt.last_used = self._tick
            if len(nxt.tokens) < ps or len(chunk) < ps:
                break  # a tail page ends the path
            node = nxt
        return adopted, released

    def evict(self, n_pages: int, busy) -> List[int]:
        """Drop up to ``n_pages`` least-recently-used LEAF pages whose
        ``busy(page)`` reports no slot reference; returns the released
        page ids (the caller unrefs them back to the pool)."""
        released: List[int] = []
        while len(released) < n_pages:
            victim = None
            stack = [self._root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    if child.children:
                        stack.append(child)
                    elif not busy(child.page) and (
                            victim is None
                            or child.last_used < victim.last_used):
                        victim = child
            if victim is None:
                break  # everything left is pinned by live slots
            del victim.parent.children[victim.tokens]
            released.append(victim.page)
            self.resident_pages -= 1
            self.evictions += 1
        return released

    def indexed_pages(self) -> List[int]:
        """Every page the trie currently references."""
        out: List[int] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(child.page)
                stack.append(child)
        return out

    @property
    def stats(self) -> dict:
        return {"kind": "radix", "resident_pages": self.resident_pages,
                "capacity_pages": self.capacity, "hits": self.hits,
                "misses": self.misses, "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "recent_hit_rate": round(self.recent_hit_rate, 4)}


class ContinuousEngine:
    """Admit requests any time; every free KV slot is refilled at the
    next chunk boundary. ``submit`` queues, ``run_until_drained`` (or
    repeated ``step``) decodes; finished requests come back as
    ``(rid, token_list)``. A paged model (``CausalLMConfig.kv_num_pages``)
    runs over the page pool; any other over the dense slot cache, with
    the JAX engine's dense routes: the ``PrefixCache`` LRU for
    ``prefix_cache_size`` (entries, not pages), chunked prefill through
    a batch-1 staging cache extended piece by piece, and speculation
    verifying over the dense cache. ``schedule`` is the admission order
    ("fifo" or "longest"), ``tenant_weights`` the DWRR weights of the
    tenants (a ``*`` entry for unnamed ones)."""

    def __init__(self, model: CausalLM, num_slots: int = 8, chunk: int = 8,
                 eos_token_id: Optional[int] = None, pad_id: int = 0,
                 buckets: Sequence[int] = PAD_BUCKETS,
                 prefix_cache_size: int = 0,
                 prefill_chunk: int = 0, step_token_budget: int = 0,
                 pipeline_depth: int = 0, adaptive_chunk: bool = False,
                 batch_admit: bool = True,
                 schedule: str = "fifo",
                 tenant_weights: Optional[Dict[str, float]] = None,
                 stepstats: Optional[StepStatsRing] = None,
                 spec_tokens: int = 0,
                 draft_model: Optional[CausalLM] = None,
                 obs: Optional[dict] = None,
                 peak_flops: float = 0.0,
                 announce: bool = False):
        cfg = model.cfg
        # the JAX engine's flag (its invariant checker reads it)
        self.paged = cfg.paged_kv
        # announce (a multi-process server's rank 0): every device op is
        # published on the serving wire before it runs, under the
        # announce lock, and the workers replay it (train/serving.py).
        # A tp model carries its groups: the engine takes no mesh.
        self.announce = bool(announce)
        if pipeline_depth > 1 and announce:
            raise ValueError(
                "pipeline_depth >= 2 is single-host only (the announce "
                "replay's deferred-chunk window is depth-1 sized)")
        if prefill_chunk and announce and not self.paged:
            raise ValueError(
                "dense chunked prefill is single-host only (announce "
                "mode); the paged engine replays chunk progress over "
                "the wire")
        if prefix_cache_size and announce and not self.paged:
            raise ValueError(
                "dense prefix caching is single-host only (announce "
                "mode); the paged radix cache replays over the wire")
        if num_slots < 1 or chunk < 1:
            raise ValueError("num_slots and chunk must be >= 1")
        if schedule not in ("fifo", "longest"):
            raise ValueError(
                f"schedule must be 'fifo' or 'longest', got {schedule!r}")
        # "longest" = LPT admission: the queue stays sorted by budget, so
        # long requests anchor the slots early and short ones fill the
        # gaps (throughput over first-come latency)
        self.schedule = schedule
        if pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")
        if prefill_chunk and prefill_chunk < 32:
            raise ValueError(
                f"prefill_chunk must be 0 (off) or >= 32, got "
                f"{prefill_chunk} (tiny pieces spend more dispatches "
                "than they save)")
        if step_token_budget < 0:
            raise ValueError(
                f"step_token_budget must be >= 0, got {step_token_budget}")
        # pipeline_depth=N ("decode-ahead"): keep up to N dispatched
        # chunks un-collected, so the host's scheduling and bookkeeping
        # overlap the in-flight chunks' compute; token content per
        # request is unchanged, frees and admissions land up to N chunks
        # later (bounded extra dead-row compute, discarded by the host's
        # budget clamp). adaptive_chunk: size each dispatch to the
        # smallest remaining budget over the live slots.
        self.pipeline_depth = int(pipeline_depth)
        self.adaptive_chunk = bool(adaptive_chunk)
        # batch_admit=False admits one request at a time: the A/B lever
        # for what the batched prefill buys
        self.batch_admit = bool(batch_admit)
        # prefill_chunk: prompts longer than this admit one piece a step;
        # step_token_budget ("Sarathi-style"): cap one step's work at
        # ~this many tokens, split between the prefill piece and the
        # decode chunk (live slots x steps, bucketed down to a power of
        # two, floored at 1). 0 = off.
        self.prefill_chunk = int(prefill_chunk)
        self.step_token_budget = int(step_token_budget)
        self.model = model
        self.device = model.device
        self.num_slots, self.chunk = num_slots, chunk
        self.eos_token_id, self.pad_id = eos_token_id, pad_id
        s_max = cfg.max_seq_len
        ps = cfg.kv_page_size
        if self.paged and s_max % ps:
            raise ValueError(f"kv_page_size {ps} must divide max_seq_len "
                             f"{s_max}")
        if buckets is PAD_BUCKETS:
            buckets = tuple(b for b in PAD_BUCKETS if b < s_max) + (s_max,)
        # paged: prefill rows scatter whole pages, so every bucket is
        # page-aligned
        self.buckets = tuple(b for b in buckets if b <= s_max and (
            not self.paged or b % ps == 0))
        if not self.buckets:
            raise ValueError(f"no prompt bucket fits max_seq_len {s_max}"
                             + (f" as a multiple of kv_page_size {ps}"
                                if self.paged else ""))
        # paged: the radix prefix cache over the page pool,
        # prefix_cache_size capping its resident pages (clamped to the
        # pool; LRU-evicted under pool pressure either way); dense: the
        # LRU of prefix_cache_size batch-1 entries
        self.radix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(ps, min(int(prefix_cache_size),
                                     cfg.kv_num_pages))
            if prefix_cache_size and self.paged else None)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(int(prefix_cache_size))
            if prefix_cache_size and not self.paged else None)
        self._free_pages: List[int] = list(range(cfg.kv_num_pages or 0))
        # page -> refcount: slots and in-flight admissions hold one ref
        # per page they reference, the trie one per page it indexes; a
        # page is in _free_pages iff its refcount is 0
        self._page_refs: Dict[int, int] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._peak_pages_in_use = 0
        self._n_page_alloc_failures = 0
        itemsize = 1 if cfg.kv_cache_quant else cfg.dtype.itemsize
        self._page_bytes_per_layer = (
            2 * ps * cfg.kv_heads * cfg.head_dim * itemsize
            + (2 * ps * cfg.kv_heads * 4 if cfg.kv_cache_quant else 0))
        self._rid = itertools.count()
        self._queue: List[_Request] = []
        # DWRR over per-tenant subqueues, consulted only once two
        # distinct tenants have submitted (``_fair_active``)
        self._fair = DwrrScheduler(tenant_weights)
        self._first_tenant: Optional[str] = None
        self._fair_active = False
        self._n_deadline_expired = 0
        self._slots: Dict[int, _Request] = {}
        self._admitting: Optional[dict] = None  # the piecewise admission
        # dispatched-but-unsettled chunks, oldest first; admission work
        # whose device-busy interval is still open
        self._inflight_q: Deque[_InflightStep] = deque()
        self._admit_q: Deque[_InflightStep] = deque(maxlen=32)
        self._n_finished = 0
        self._n_batch_admits = 0
        self._n_solo_admits = 0
        self._n_dispatched_steps = 0
        self._n_prefill_tokens = 0
        self._n_prefill_chunks = 0     # pieces processed
        self._step_prefill_tokens = 0  # this step's piece tokens
        self.stepstats = (stepstats if stepstats is not None
                          else StepStatsRing())
        # the metrics plane: the serving front passes its registry's
        # handles; a direct caller gets the process registry's
        self._obs = obs if obs is not None else platform_families()
        self._obs["serve_slots_total"].set(num_slots)
        self._obs["serve_prefill_inflight"].set(0)
        if self.paged:
            self._obs["serve_kv_pages_total"].set(cfg.kv_num_pages)
        # peak_flops arms the windowed serve_mfu gauge (0 = off, the CPU
        # default; FLOPs a token are estimated from the config)
        self.stepstats.bind(self._obs, flops_per_token=flops_per_token(cfg),
                            peak_flops=peak_flops)
        self._step_rec = None
        # speculative decoding: spec_tokens draft proposals a slot a
        # round, ONE multi-query verify; no draft model = SELF-draft (the
        # target proposes for itself through a dense shadow cache)
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        self.spec_tokens = int(spec_tokens)
        self._spec = self.spec_tokens > 0
        if (draft_model is not None
                and draft_model.cfg.vocab_size != cfg.vocab_size):
            raise ValueError(
                f"draft vocab {draft_model.cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: the models must share a tokenizer")
        self._self_draft = self._spec and draft_model is None
        # the device half: slot state, draft slots, captured chunks (a
        # worker's replica runs the same class)
        self._device = SlotDeviceState(
            model, num_slots, draft_model if self._spec else None,
            self.spec_tokens)
        # whether chunks replay CUDA graphs: not under a gloo tp group,
        # whose collectives cannot be captured (decided once)
        self.captured = self._device.captured
        self._tp = model.spmd.tp if model.spmd is not None else None
        self._n_spec_rounds = 0
        self._n_spec_proposed = 0
        self._n_spec_accepted = 0
        # (proposed, accepted) of the last collected spec chunks
        self._spec_window: Deque[tuple] = deque(maxlen=_SPEC_WINDOW)

    @property
    def _state(self) -> SlotState:
        return self._device.state

    @property
    def _draft(self) -> Optional[DraftSlots]:
        return self._device.draft

    @property
    def _graphs(self) -> Dict[tuple, graphs.Captured]:
        return self._device.graphs

    def _announced(self, announce_thunk, device_thunk):
        """Announce an op and run its device work under one hold of the
        announce lock (the workers run ops in announce order, so rank
        0's device work must run in that order); without ``announce``,
        the device work alone."""
        if not self.announce:
            return device_thunk()
        from pyspark_tf_gke_tpu_torch.train import serving

        with serving.mh_lock():
            announce_thunk(serving)
            return device_thunk()

    # -- submission ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               on_tokens: Optional[Callable[[List[int]], None]] = None,
               temperature: float = 0.0, top_p: Optional[float] = None,
               seed: int = 0, deadline_s: Optional[float] = None,
               tenant: str = "default", span=None) -> int:
        """Queue a request; returns its id. ``on_tokens`` receives each
        collected token group, ``deadline_s`` (seconds from now) expires
        it at a chunk boundary, ``tenant`` is its fairness identity and
        ``span`` its trace span (annotated at each state transition)."""
        if temperature and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        cfg = self.model.cfg
        if prompt.size + max_new_tokens > cfg.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds max_seq_len {cfg.max_seq_len}")
        if self._chunked_route(prompt.size):
            # pieces write real tokens only and touch no bucket: the
            # bound is max_seq_len (above) and the true token extent
            need = -(-(prompt.size + max_new_tokens) // cfg.kv_page_size)
        else:  # raises when no bucket fits
            sb = bucket_length(prompt.size, self.buckets)
            need = self._pages_needed(sb, prompt.size, max_new_tokens)
        if self.paged and need > cfg.kv_num_pages:
            # with the whole pool free it still could not admit —
            # queueing it would livelock run_until_drained
            raise ValueError(
                f"request needs {need} KV pages but the pool has "
                f"{cfg.kv_num_pages} (page_size {cfg.kv_page_size})")
        tenant = str(tenant) or "default"
        if self._first_tenant is None:
            self._first_tenant = tenant
        elif not self._fair_active and tenant != self._first_tenant:
            self._fair_active = True  # two tenants seen: DWRR from here
        # the request's shape onto its trace (idempotent with the serving
        # front's earlier stamp; direct callers get it here)
        annotate_request_shape(span, tenant=tenant,
                               prompt_tokens=int(prompt.size),
                               max_new_tokens=max_new_tokens,
                               deadline_s=deadline_s)
        now = time.monotonic()
        req = _Request(next(self._rid), prompt, int(max_new_tokens),
                       tenant=tenant, enqueued_at=now, on_tokens=on_tokens,
                       temperature=float(temperature or 0.0), top_p=top_p,
                       seed=int(seed),
                       deadline=(now + float(deadline_s)
                                 if deadline_s is not None else None),
                       span=span)
        if self.schedule == "longest":
            # keep the queue budget-descending; ties stay FIFO
            i = 0
            while (i < len(self._queue)
                   and self._queue[i].max_new_tokens >= max_new_tokens):
                i += 1
            self._queue.insert(i, req)
        else:
            self._queue.append(req)
        return req.rid

    def _chunked_route(self, prompt_len: int) -> bool:
        return bool(self.prefill_chunk and prompt_len > self.prefill_chunk)

    def cancel(self, rid: int) -> bool:
        """Drop a queued request, free the slot of an active one (an
        in-flight decode-ahead snapshot skips it at collect), or abandon
        the piecewise admission of one (its pages return)."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                req.done = True
                del self._queue[i]
                self._trace_terminal(req, "cancelled")
                return True
        for slot, req in list(self._slots.items()):
            if req.rid == rid:
                req.done = True
                del self._slots[slot]
                self._free_slot(slot)
                self._trace_terminal(req, "cancelled")
                return True
        if self._admitting is not None and self._admitting["req"].rid == rid:
            req = self._admitting["req"]
            req.done = True
            self._drop_admitting()
            self._trace_terminal(req, "cancelled")
            return True
        return False

    @staticmethod
    def _trace_terminal(req: _Request, outcome: str) -> None:
        """The terminal span event of a transition other than delivery
        (cancel, a rebuild's error, a reload's shed)."""
        if req.span is not None:
            req.span.event("terminal", rid=req.rid, outcome=outcome,
                           new_tokens=len(req.tokens))

    @staticmethod
    def _trace_admit(req: _Request, slot: int, route: str,
                     **fields) -> None:
        """Span events at the moment a request wins a KV slot: the
        measured queue wait and the admission route."""
        sp = req.span
        if sp is None:
            return
        sp.event("queue_wait", rid=req.rid,
                 ms=round((time.monotonic() - req.enqueued_at) * 1000.0, 3))
        sp.event("admission", rid=req.rid, slot=slot, route=route,
                 **fields)

    # -- prefix cache: warm, export, import ------------------------------
    def _require_radix(self, what: str) -> None:
        if self.radix is None:
            raise ValueError(f"{what} needs the paged radix prefix cache "
                             "(prefix_cache_size > 0 on a paged model)")

    @property
    def warm_capacity(self) -> int:
        """How many warmed prefixes a rebuilt engine should replay: the
        dense LRU's entry capacity, or a fixed horizon of 8 for the radix
        cache (its residency is page-bounded, not entry-bounded)."""
        if self.prefix_cache is not None:
            return self.prefix_cache.capacity
        return 8 if self.radix is not None else 0

    def warm_prefix(self, prefix_ids) -> int:
        """Prefill ``prefix_ids`` STRAIGHT into trie-owned pages (no slot
        involved) and index it, so later prompts starting with it admit
        at the match boundary; restarts from the last fully cached page
        when part of it is resident. A dense engine prefills it into a
        batch-1 staging cache and keeps that in its ``PrefixCache`` LRU.
        Returns the prefix length."""
        if self.prefix_cache is None:
            self._require_radix("warm_prefix")
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        if prefix.size == 0:
            raise ValueError("empty prefix")
        cfg = self.model.cfg
        if prefix.size >= cfg.max_seq_len:
            raise ValueError(
                f"prefix {prefix.size} leaves no room under max_seq_len "
                f"{cfg.max_seq_len}")
        if self.prefix_cache is not None:
            padded = np.full((bucket_length(prefix.size, self.buckets),),
                             self.pad_id, np.int32)
            padded[:prefix.size] = prefix
            with torch.no_grad():
                cache1, logits1 = _prefill_padded(self.model, padded,
                                                  int(prefix.size))
            self._n_prefill_tokens += int(prefix.size)
            self.prefix_cache.put(prefix, cache1, logits1)
            return int(prefix.size)
        ps = cfg.kv_page_size
        matched, shared, _cow = self.radix.match(
            prefix, limit=int(prefix.size), peek=True)
        if matched >= prefix.size:
            # every prefix token is derivable from cached pages: touch
            # the path (LRU) without counting an admission
            self.radix.match(prefix, limit=int(prefix.size), count=False)
            return int(prefix.size)
        fill = len(shared) * ps  # restart at the last FULL cached page
        need = -(-int(prefix.size) // ps) - len(shared)
        self._ref_pages(shared)  # pin through the pieces below
        taken = self._take_pages(need)
        if taken is None:
            self._unref_pages(shared)
            raise ValueError(
                f"KV page pool cannot hold the prefix ({need} pages "
                f"needed, {len(self._free_pages)} free after eviction)")
        row = np.full((cfg.max_pages_per_slot,), cfg.kv_num_pages, np.int32)
        row[:len(shared)] = shared
        row[len(shared):len(shared) + need] = taken
        try:
            while fill < prefix.size:
                if self.prefill_chunk:
                    w = min(self.prefill_chunk, cfg.max_seq_len - fill)
                else:
                    rem = int(prefix.size) - fill
                    w = min(-(-rem // 32) * 32, cfg.max_seq_len - fill)
                piece = prefix[fill:fill + w]
                padded = np.full((1, w), self.pad_id, np.int32)
                padded[0, :piece.size] = piece
                # a piece into trie-owned pages: never final, no slot
                self._announced(
                    lambda wire, padded=padded, piece=piece, f0=fill:
                        wire.announce_cb_admit(
                            self.num_slots, padded, piece.size, 0,
                            self.eos_token_id, self.pad_id, pages=row,
                            chunk_fill=f0),
                    lambda padded=padded, piece=piece, f0=fill:
                        self._device.prefill_chunk(padded, f0, piece.size,
                                                   row))
                self._n_prefill_tokens += int(piece.size)
                fill += int(piece.size)
        except BaseException:
            self._unref_pages(list(shared) + taken)
            raise
        # trie refs keep the pages; the warm's own holds drop with them
        self._adopt_into_trie(prefix, list(shared) + taken,
                              holds=list(shared) + taken)
        return int(prefix.size)

    def export_prefix_pages(self, prefix_ids) -> Optional[dict]:
        """Prefill side of a KV handoff: the radix-cached FULL pages
        covering ``prefix_ids`` read back to the host, pinned (+1 ref)
        across the read. None when not even one full page is cached,
        else ``{token_ids, page_size, layers}`` with one dict of numpy
        arrays per layer in wire order (bf16 pools as float32)."""
        self._require_radix("KV export")
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        if prefix.size == 0:
            raise ValueError("empty prefix")
        ps = self.model.cfg.kv_page_size
        _matched, shared, _cow = self.radix.match(
            prefix, limit=int(prefix.size), peek=True)
        if not shared:
            return None
        self._ref_pages(shared)
        try:
            layers = self._read_pages(shared)
        finally:
            self._unref_pages(shared)
        return {"token_ids": [int(t) for t in prefix[:len(shared) * ps]],
                "page_size": int(ps), "layers": layers}

    def import_prefix_pages(self, token_ids, layers) -> int:
        """Decode side of a KV handoff: install the transferred page
        rows into this pool and adopt them into the radix trie, so the
        importing request and every later same-prefix admission hit
        locally. Returns the number of prefix tokens now derivable from
        cached pages."""
        self._require_radix("KV import")
        prefix = np.asarray(token_ids, np.int32).reshape(-1)
        cfg = self.model.cfg
        ps = cfg.kv_page_size
        if len(layers) != cfg.num_layers:
            raise ValueError(f"KV transfer carries {len(layers)} layers, "
                             f"the model has {cfg.num_layers}")
        # full pages only, and room for >= 1 new token
        n = min(int(prefix.size), cfg.max_seq_len - 1) // ps
        if n <= 0:
            raise ValueError(
                f"KV transfer smaller than one page "
                f"(page_size {ps}, got {prefix.size} tokens)")
        prefix = prefix[:n * ps]
        _matched, shared, _cow = self.radix.match(
            prefix, limit=int(prefix.size), peek=True)
        if len(shared) >= n:
            self.radix.match(prefix, limit=int(prefix.size), count=False)
            return int(prefix.size)
        need = n - len(shared)
        self._ref_pages(shared)  # pin through the install below
        taken = self._take_pages(need)
        if taken is None:
            self._unref_pages(shared)
            raise ValueError(
                f"KV page pool cannot hold the transfer ({need} pages "
                f"needed, {len(self._free_pages)} free after eviction)")
        # install only the rows BEYOND the locally cached pages
        blobs = [{key: np.asarray(leaf)[len(shared):n]
                  for key, leaf in rec.items()} for rec in layers]
        try:
            self._write_pages(taken, blobs)
        except BaseException:
            self._unref_pages(list(shared) + taken)
            raise
        self._adopt_into_trie(prefix, list(shared) + taken,
                              holds=list(shared) + taken)
        return int(prefix.size)

    def _read_pages(self, pages) -> List[dict]:
        """The rows of ``pages`` with every KV head, host numpy, one dict
        a layer in wire order (``SlotDeviceState.read_pages``). Under tp
        the ranks' heads are gathered, so the workers are told
        (``OP_KV_READ``)."""
        if self._tp is None:
            return self._device.read_pages(pages)
        return self._announced(
            lambda wire: wire.announce_kv_read(self.num_slots, pages),
            lambda: self._device.read_pages(pages))

    def _write_pages(self, pages, blobs) -> None:
        """Install transferred page rows (every KV head; each rank keeps
        its own) at ``pages`` on every rank (``OP_KV_XFER``)."""
        self._announced(
            lambda wire: wire.announce_kv_xfer(self.num_slots, pages, blobs),
            lambda: self._device.write_pages(pages, blobs))

    # -- page pool (host side) -------------------------------------------
    def _pages_needed(self, s_bucket: int, true_len: int,
                      max_new: int) -> int:
        """Pages covering BOTH the padded prefill scatter (``s_bucket``
        rows land in pages) and the request's maximum token extent."""
        ps = self.model.cfg.kv_page_size
        return -(-max(int(s_bucket), int(true_len) + int(max_new)) // ps)

    def _note_peak(self) -> None:
        used = self.model.cfg.kv_num_pages - len(self._free_pages)
        self._peak_pages_in_use = max(self._peak_pages_in_use, used)
        self._obs["serve_kv_pages_in_use"].set(used)
        self._obs["serve_kv_cache_bytes_per_layer"].set(
            used * self._page_bytes_per_layer)

    def _ref_pages(self, pages) -> None:
        """+1 refcount on every page (a slot, an admission or the trie
        took a reference)."""
        for p in pages:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1

    def _unref_pages(self, pages) -> None:
        """-1 refcount; pages reaching zero return to the free list.
        Raises on a double free."""
        for p in pages:
            left = self._page_refs.get(p, 0) - 1
            if left > 0:
                self._page_refs[p] = left
            elif left == 0:
                del self._page_refs[p]
                self._free_pages.append(p)
            else:
                raise RuntimeError(
                    f"KV page {p} unreferenced while already free "
                    "(double free)")

    def _adopt_into_trie(self, tokens, pages,
                         holds: Optional[List[int]] = None) -> None:
        """Index ``tokens`` over ``pages`` and move the refcounts in ONE
        place: +1 per page the trie adopts, -1 per page it releases,
        then the caller's own ``holds`` drop and the resident-page cap
        is enforced."""
        adopted, released = self.radix.insert(tokens, pages)
        if adopted:
            self._ref_pages(adopted)
        if released:
            self._unref_pages(released)
        if holds:
            self._unref_pages(holds)
        self._enforce_cache_cap()

    def _evict_cache_pages(self, n: int) -> int:
        """LRU-evict up to ``n`` trie-resident pages with no slot
        reference back to the free list; returns how many freed."""
        released = self.radix.evict(
            n, busy=lambda p: self._page_refs.get(p, 0) > 1)
        if released:
            self._unref_pages(released)
        return len(released)

    def _enforce_cache_cap(self) -> None:
        over = (self.radix.resident_pages - self.radix.capacity
                if self.radix is not None else 0)
        if over > 0:
            self._evict_cache_pages(over)

    def _take_pages(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages (refcount 1 each); under pressure the
        radix cache's coldest resident pages are evicted first. None
        when even that cannot cover ``n``."""
        if n > len(self._free_pages) and self.radix is not None:
            self._evict_cache_pages(n - len(self._free_pages))
        if n > len(self._free_pages):
            return None
        taken = [self._free_pages.pop() for _ in range(n)]
        for p in taken:
            self._page_refs[p] = 1
        self._note_peak()
        return taken

    def _alloc_pages(self, n: int):
        """``(row, taken)`` — the sentinel-padded ``[max_pages_per_slot]``
        block-table row and the page list — or None when the pool cannot
        cover ``n`` (the request stays queued)."""
        taken = self._take_pages(n)
        if taken is None:
            self._n_page_alloc_failures += 1
            return None
        cfg = self.model.cfg
        row = np.full((cfg.max_pages_per_slot,), cfg.kv_num_pages, np.int32)
        row[:n] = taken
        return row, taken

    def _release_pages(self, slot: int) -> None:
        taken = self._slot_pages.pop(slot, None)
        if taken:
            self._unref_pages(taken)

    def _free_slot(self, slot: int) -> None:
        self._announced(
            lambda wire: wire.announce_cb_free(self.num_slots, slot),
            lambda: self._device.free(slot))
        self._release_pages(slot)

    # -- admission -------------------------------------------------------
    def _draft_payload(self, req: _Request):
        """``(padded [1, w], true_len)`` for the admission's draft
        prefill, or None when speculation is off or the prompt cannot
        fit the draft's context (the slot then runs on a COLD draft row:
        its proposals are rejected — slower, never wrong). Width: the
        smallest engine bucket that fits the draft, else a multiple of
        32, bounded by the draft's max_seq_len."""
        if not self._spec:
            return None
        d_max = self._draft.model.cfg.max_seq_len
        n = int(req.prompt.size)
        if n >= d_max:
            return None
        cands = [x for x in self.buckets if n <= x <= d_max]
        w = min(cands) if cands else min(-(-n // 32) * 32, d_max)
        padded = np.full((1, w), self.pad_id, np.int32)
        padded[0, :n] = req.prompt
        return padded, n

    def _draft_admit(self, slot: int, req: _Request) -> None:
        """The draft's half of an admission on a single-host route (a
        dense prefix hit or chunked admission): prefill the whole prompt
        into the slot's draft row. Announced routes carry it as the
        admit's draft payload."""
        dp = self._draft_payload(req)
        if dp is not None:
            self._device.draft_prefill_row(dp[0], dp[1], slot)

    def _device_admit(self, group: List[_Request], slots: List[int],
                      sb: int, pages_b: Optional[np.ndarray]) -> None:
        """ONE batched prefill + ONE scatter admits ``group`` (and, under
        speculation, the draft's prefill of the same prompts); a paged
        engine scatters into ``pages_b``, a dense one into the slots'
        rows. One request is one announced op (batched admission is
        single-host, as in the JAX engine)."""
        padded = np.full((len(group), sb), self.pad_id, np.int32)
        lens = np.zeros((len(group),), np.int32)
        for i, req in enumerate(group):
            padded[i, :req.prompt.size] = req.prompt
            lens[i] = req.prompt.size
        samplings = [wire_sampling(r) for r in group]
        if len(group) == 1:
            dp = self._draft_payload(group[0])

            def device():
                self._device.admit(padded, lens, slots, samplings, pages_b)
                if dp is not None:
                    self._device.draft_prefill_row(dp[0], dp[1], slots[0])

            self._announced(
                lambda wire: wire.announce_cb_admit(
                    self.num_slots, padded, lens[0], slots[0],
                    self.eos_token_id, self.pad_id, sampling=samplings[0],
                    pages=pages_b[0] if pages_b is not None else None,
                    draft=dp),
                device)
        else:
            self._device.admit(padded, lens, slots, samplings, pages_b)
            if self._spec and sb <= self._draft.model.cfg.max_seq_len:
                # the group's shared bucket fits the draft: one batched
                # draft prefill
                self._device.draft_prefill_rows(padded, lens, slots)
            elif self._spec:
                # a bucket too wide for the draft: each request's own
                for slot, req in zip(slots, group):
                    self._draft_admit(slot, req)
        self._n_prefill_tokens += int(lens.sum())

    def _admit_group(self, group: List[_Request], slots: List[int],
                     sb: int, allocs: List[tuple], route: str) -> None:
        """Admit ``group`` into ``slots`` through one bucket-``sb``
        prefill; ``allocs`` holds each request's ``(row, pages)`` (empty
        for a dense engine)."""
        pages_b = np.stack([row for row, _ in allocs]) if allocs else None
        try:
            if route == "paged":
                # chaos: a crash between the page allocation and the
                # prefill landing (the except below returns every page)
                chaos_fire("engine.admit", rid=group[0].rid)
            self._device_admit(group, slots, sb, pages_b)
        except BaseException:
            for _, taken in allocs:  # a failed admit must not leak pages
                self._unref_pages(taken)
            raise
        for i, (slot, req) in enumerate(zip(slots, group)):
            self._slots[slot] = req
            if allocs:
                self._slot_pages[slot] = allocs[i][1]
            self._trace_admit(req, slot, route)
            if self.radix is not None:
                self.radix.note(0)  # bucket admissions are misses

    def _admit_batch(self, free: List[int]) -> None:
        """Batched admission: the FIFO prefix of the queue that shares
        one prompt bucket and fits the pool prefills in one forward. The
        batch stops at the first request needing another bucket, the
        piecewise route (chunked, or a radix hit) or more pages than
        remain."""
        group: List[_Request] = []
        needs: List[int] = []
        sb0 = None
        pages_left = len(self._free_pages)
        for req in self._queue:
            if len(group) >= len(free):
                break
            if self._chunked_route(req.prompt.size):
                break  # piecewise route
            if (self.radix is not None
                    and self.radix.match(req.prompt, peek=True)[0]):
                break  # a radix hit prefills its suffix only
            if (self.prefix_cache is not None
                    and self.prefix_cache.lookup(req.prompt, peek=True)):
                break  # the hit path is cheaper than a fresh prefill
            sb = bucket_length(req.prompt.size, self.buckets)
            if sb0 is None:
                sb0 = sb
            elif sb != sb0:
                break
            if self.paged:
                need = self._pages_needed(sb, req.prompt.size,
                                          req.max_new_tokens)
                if need > pages_left:
                    break
                pages_left -= need
                needs.append(need)
            group.append(req)
        if len(group) < 2:
            return
        allocs = [self._alloc_pages(n) for n in needs]  # covered above
        self._admit_group(group, free[:len(group)], sb0, allocs, "batch")
        del self._queue[:len(group)]
        for req in group:  # batched admission runs single-tenant only
            self._fair.tally(req)
        self._n_batch_admits += len(group)

    def _try_admit(self, slot: int, req: _Request) -> bool:
        """Admit ``req`` into ``slot``, or START its piecewise admission
        (a long prompt under chunked prefill, or any radix-cache hit);
        False when the pool cannot cover it yet or a piecewise admission
        is already in flight (FIFO holds; the request stays queued)."""
        if not self.paged:
            return self._try_admit_dense(slot, req)
        # ONE trie walk decides the route AND seeds the admission
        # (count=False: the stats wait for the final post-COW outcome)
        m = (self.radix.match(req.prompt, count=False)
             if self.radix is not None else (0, [], None))
        if m[0] or self._chunked_route(req.prompt.size - m[0]):
            if self._admitting is not None:
                return False  # one piecewise admission at a time
            self._start_paged_admission(slot, req, m)
            return True
        sb = bucket_length(req.prompt.size, self.buckets)
        alloc = self._alloc_pages(self._pages_needed(
            sb, req.prompt.size, req.max_new_tokens))
        if alloc is None:
            return False
        self._admit_group([req], [slot], sb, [alloc], "paged")
        return True

    def _try_admit_dense(self, slot: int, req: _Request) -> bool:
        """The dense engine's admission (the JAX engine's dense routes):
        a prompt whose remainder past its ``PrefixCache`` hit exceeds
        ``prefill_chunk`` STARTS a piecewise admission; any other hit
        extends a clone of the cached entry by the remainder
        (:meth:`_admit_from_prefix`); everything else is one bucket
        prefill copied into the slot. False only when a piecewise
        admission is needed and one is already in flight."""
        if (self._admitting is not None
                and self._chunked_route(req.prompt.size)):
            # peek (no stats or LRU churn on every retried step): a hit
            # may shrink the remainder under the threshold
            hit = (self.prefix_cache.lookup(req.prompt, peek=True)
                   if self.prefix_cache is not None else None)
            if self._chunked_route(req.prompt.size
                                   - (hit[0] if hit is not None else 0)):
                return False
        hit = (self.prefix_cache.lookup(req.prompt)
               if self.prefix_cache is not None else None)
        matched = hit[0] if hit is not None else 0
        if hit is not None:
            self._obs["serve_prefix_cache_hits_total"].inc()
            self._obs["serve_prefix_cache_hit_tokens_total"].inc(matched)
        if self._chunked_route(req.prompt.size - matched):
            # one piece a step; the first piece prefills unless a hit
            # seeds the staging cache (a clone: the entry stays as it is)
            self._admitting = {
                "slot": slot, "req": req, "fill": matched,
                "cache1": hit[1].clone() if hit is not None else None}
            self._trace_admit(req, slot, "chunked",
                              prefix_hit_tokens=matched)
            self._advance_admission()
            return True
        if hit is not None:
            self._trace_admit(req, slot, "prefix", prefix_hit_tokens=matched)
            self._admit_from_prefix(slot, req, *hit)
            with torch.no_grad():
                self._draft_admit(slot, req)
            self._slots[slot] = req
            return True
        self._admit_group([req], [slot],
                          bucket_length(req.prompt.size, self.buckets), [],
                          "dense")
        return True

    def _admit_from_prefix(self, slot: int, req: _Request, fill: int,
                           cache1: DenseCache,
                           logits1: Optional[torch.Tensor]) -> None:
        """Admission on a dense prefix-cache hit: only the prompt
        REMAINDER pays a forward (one multi-token extension of a clone of
        the cached batch-1 cache), then the cache drops into the slot.
        The remainder's width is the smallest engine bucket that fits
        both it and the room above ``fill``, else a multiple of 32, else
        the exact room near the context limit (a wider write would be
        clamped onto earlier rows)."""
        rem = req.prompt[fill:]
        with torch.no_grad():
            if rem.size:
                room = self.model.cfg.max_seq_len - fill
                fits = [b for b in self.buckets if rem.size <= b <= room]
                quant = -(-int(rem.size) // 32) * 32
                w = min(fits) if fits else min(quant, room)
                padded = np.full((w,), self.pad_id, np.int32)
                padded[:rem.size] = rem
                cache1 = cache1.clone()
                logits1 = _extend_prefix(self.model, cache1, padded, fill,
                                         int(rem.size))
                self._n_prefill_tokens += int(rem.size)
            _insert_slots_batch(self._state, cache1, logits1, [slot],
                                [req.prompt.size], [req.sampling()])

    def _start_paged_admission(self, slot: int, req: _Request,
                               match=(0, [], None)) -> None:
        """Begin a piecewise admission into ``slot`` (reserved from here
        on), seeded from the radix match: the matched FULL pages are
        shared read-only (refcount +1, at the head of the admission's
        row), a match ending inside a page clones that page
        copy-on-write into a fresh one, and the pieces start at the
        match boundary. Runs the first piece."""
        cfg = self.model.cfg
        a = {"slot": slot, "req": req, "fill": 0,
             "row": np.full((cfg.max_pages_per_slot,), cfg.kv_num_pages,
                            np.int32),
             "pages": [], "shared": [], "cow": None}
        if self.radix is not None:
            matched, shared, cow = match
            if cow is not None:
                # pin the source while the clone allocates (allocation
                # may evict resident pages — never the pinned source)
                self._ref_pages([cow[0]])
                dst = self._take_pages(1)
                if dst is None:
                    # degrade to the page boundary: the full pages still
                    # share, only the tail rows recompute
                    self._unref_pages([cow[0]])
                    matched -= cow[1]
                    cow = None
                else:
                    a["cow"] = (cow[0], dst[0])
                    a["pages"].append(dst[0])
            self.radix.note(matched)
            if matched:
                self._ref_pages(shared)
                a["shared"] = list(shared)
                a["row"][:len(shared)] = shared
                if a["cow"] is not None:
                    a["row"][len(shared)] = a["cow"][1]
                a["fill"] = matched
                self._obs["serve_prefix_cache_hits_total"].inc()
                self._obs["serve_prefix_cache_hit_tokens_total"].inc(matched)
        self._trace_admit(req, slot, "paged_chunked",
                          prefix_hit_tokens=int(a["fill"]),
                          cow=a["cow"] is not None)
        self._admitting = a
        self._obs["serve_prefill_inflight"].set(1)
        self._advance_admission()

    def _advance_admission(self) -> None:
        """One piece of the piecewise admission: extend its page
        allocation to cover the piece's real tokens (the final piece
        claims the whole decode extent — nothing is allocated
        mid-decode), clone the copy-on-write page before the first
        piece, write the piece's K/V into the pool, and on the final
        piece activate the slot. An unchunked engine runs a radix hit's
        whole suffix as one piece (its width a multiple of 32). Pool
        dry: the admission stalls (no piece; one allocation failure
        counted a stalled step) and resumes after frees."""
        if not self.paged:
            return self._advance_admission_dense()
        a = self._admitting
        req, fill = a["req"], a["fill"]
        cfg = self.model.cfg
        # near the context limit a full-width piece would run positions
        # past max_seq_len: clamp its width
        if self.prefill_chunk:
            w = min(self.prefill_chunk, cfg.max_seq_len - fill)
        else:
            rem = int(req.prompt.size) - fill
            w = min(-(-rem // 32) * 32, cfg.max_seq_len - fill)
        piece = req.prompt[fill:fill + w]
        final = fill + piece.size == req.prompt.size
        covered = len(a["shared"]) + len(a["pages"])
        need_tokens = (req.prompt.size + req.max_new_tokens if final
                       else fill + piece.size)
        need = -(-need_tokens // cfg.kv_page_size) - covered
        if need > 0:
            taken = self._take_pages(need)
            if taken is None:
                self._n_page_alloc_failures += 1
                return  # stall: frees at later steps resume it
            a["row"][covered:covered + need] = taken
            a["pages"].extend(taken)
        padded = np.full((1, w), self.pad_id, np.int32)
        padded[0, :piece.size] = piece
        cow = a["cow"]
        sampling = wire_sampling(req)
        # the draft's context spans the WHOLE prompt (a radix match
        # boundary included: shared pages never cross into the draft's
        # dense rows), carried by the final piece
        dp = self._draft_payload(req) if final else None

        def device():
            if cow is not None:
                self._device.copy_page(*cow)
            logits1 = self._device.prefill_chunk(padded, fill, piece.size,
                                                 a["row"])
            if final:
                self._device.activate_slot(a["slot"], req.prompt.size,
                                           logits1, a["row"], sampling)
                if dp is not None:
                    self._device.draft_prefill_row(dp[0], dp[1], a["slot"])

        try:
            self._announced(
                lambda wire: wire.announce_cb_admit(
                    self.num_slots, padded, piece.size, a["slot"],
                    self.eos_token_id, self.pad_id,
                    sampling=sampling if final else None, pages=a["row"],
                    chunk_fill=fill, final=final, cow=cow, draft=dp),
                device)
        except BaseException:
            # a failed piece must not leak the admission's pages (the
            # caller may keep driving this engine), nor lose its request:
            # it goes back to the queue head (a first piece fails while
            # it is still there), so outstanding_requests finds it
            self._drop_admitting()
            if not any(r is req for r in self._queue):
                self._queue.insert(0, req)
            raise
        if cow is not None:
            # the clone ran: drop the source pin (the trie's own ref
            # keeps the page alive for future matches)
            a["cow"] = None
            self._unref_pages([cow[0]])
        a["fill"] = fill + piece.size
        self._note_prefill_piece(int(piece.size), req)
        if final:
            self._slots[a["slot"]] = req
            self._slot_pages[a["slot"]] = a["shared"] + a["pages"]
            self._admitting = None
            self._obs["serve_prefill_inflight"].set(0)

    def _note_prefill_piece(self, n: int, req: _Request) -> None:
        self._n_prefill_chunks += 1
        self._step_prefill_tokens += n
        self._n_prefill_tokens += n
        self._obs["serve_prefill_chunk_tokens"].observe(n)
        if req.span is not None:
            req.span.event("prefill_chunk", rid=req.rid, tokens=n)

    def _advance_admission_dense(self) -> None:
        """One piece of the dense piecewise admission, always
        ``prefill_chunk`` wide (clamped to the room under
        ``max_seq_len``, where a wider write would be clamped onto
        earlier rows): the first piece prefills a batch-1 staging cache
        (unless a prefix hit seeded it), later ones extend it in place;
        the final piece copies it into the reserved slot."""
        a = self._admitting
        req, fill = a["req"], a["fill"]
        w = min(self.prefill_chunk, self.model.cfg.max_seq_len - fill)
        piece = req.prompt[fill:fill + w]
        padded = np.full((w,), self.pad_id, np.int32)
        padded[:piece.size] = piece
        try:
            with torch.no_grad():
                if a["cache1"] is None:
                    a["cache1"], logits1 = _prefill_padded(
                        self.model, padded, int(piece.size))
                else:
                    logits1 = _extend_prefix(self.model, a["cache1"], padded,
                                             fill, int(piece.size))
                if fill + piece.size == req.prompt.size:
                    _insert_slots_batch(self._state, a["cache1"], logits1,
                                        [a["slot"]], [req.prompt.size],
                                        [req.sampling()])
                    self._draft_admit(a["slot"], req)
        except BaseException:
            # the request goes back to the queue head (a first piece
            # fails while it is still there), so outstanding_requests
            # finds it
            self._drop_admitting()
            if not any(r is req for r in self._queue):
                self._queue.insert(0, req)
            raise
        a["fill"] = fill + piece.size
        self._note_prefill_piece(int(piece.size), req)
        if a["fill"] == req.prompt.size:
            self._slots[a["slot"]] = req
            self._admitting = None
            self._obs["serve_prefill_inflight"].set(0)

    def _drop_admitting(self) -> None:
        """Abandon the piecewise admission (cancel, failed piece): every
        page reference it holds drops — owned pages return to the pool,
        shared prefix pages fall back to their trie/other-slot refs, a
        pending copy-on-write source loses its pin. The slot's table row
        was never set, so what the pieces wrote is unreachable."""
        a, self._admitting = self._admitting, None
        if a is None:
            return
        self._obs["serve_prefill_inflight"].set(0)
        if not self.paged:
            return  # the staging cache goes with the dict
        if a["cow"] is not None:
            self._unref_pages([a["cow"][0]])
        drop = list(a["shared"]) + list(a["pages"])
        if drop:
            self._unref_pages(drop)

    def _radix_insert(self, slot: int, req: _Request) -> None:
        """Index a FINISHED request's pages: they hold valid KV for
        prompt + emitted tokens (minus a trailing eos, which is emitted
        but never fed back). Near the context limit the insert is
        skipped, as the JAX engine skips it: rows still live on the
        device after the host-side finish (up to ``(pipeline_depth + 1)
        * _chunk_token_bound()`` positions of overshoot) can reach
        ``max_seq_len``, where the JAX model's paged write lands a
        garbage row in the LAST page (this model's write sends it to the
        trash page); the same trie contents keep the two engines' cache
        stats equal."""
        pages = self._slot_pages.get(slot)
        if not pages:
            return
        s_max = self.model.cfg.max_seq_len
        if (req.prompt.size + req.max_new_tokens
                + (self.pipeline_depth + 1) * self._chunk_token_bound()
                >= s_max):
            return
        toks = [int(t) for t in req.prompt] + list(req.tokens)
        if (self.eos_token_id is not None and toks
                and toks[-1] == self.eos_token_id):
            toks.pop()
        if not toks:
            return
        n_pages = -(-len(toks) // self.model.cfg.kv_page_size)
        self._adopt_into_trie(toks, pages[:n_pages])

    def _chunk_token_bound(self) -> int:
        """Upper bound on a slot's fill advance from ONE dispatched
        chunk (the overshoot term of the near-limit radix guard): a plain
        chunk advances by at most ``chunk``; a spec chunk by 1 (entry) +
        rounds x (k+1) accepted + correction tokens (+1 exit feed)."""
        if not self._spec:
            return self.chunk
        k = self.spec_tokens
        return 2 + max(1, self.chunk // (k + 1)) * (k + 1)

    def _admit_waiting(self) -> None:
        reserved = (self._admitting["slot"]
                    if self._admitting is not None else None)

        def free_slots():
            return [s for s in range(self.num_slots)
                    if s not in self._slots and s != reserved]

        free = free_slots()
        if (self.batch_admit and len(free) >= 2 and len(self._queue) >= 2
                and not self.announce and self._admitting is None
                and not self._fair_active):
            # the batched prefill is not on the wire: announce mode keeps
            # the per-request ops. A multi-tenant queue skips the batch
            # too: it takes the queue PREFIX, which would let one
            # tenant's burst jump the DWRR order
            self._admit_batch(free)
            free = free_slots()
        while free and self._queue:
            # single tenant: index 0 (the FIFO / LPT order); several:
            # the DWRR pick between the tenants' subqueues
            idx = self._fair.pick(self._queue) if self._fair_active else 0
            req = self._queue[idx]
            if not self._try_admit(free[0], req):
                break  # pool dry / piecewise admission busy; the pick
                #        and its banked deficit hold for the next step
            free.pop(0)
            self._queue.pop(idx)
            if self._fair_active:
                self._fair.charge(req)
            else:
                self._fair.tally(req)
            self._n_solo_admits += 1

    def _expire_deadlines(self) -> List[_Request]:
        """Chunk-boundary deadline enforcement: a queued request past its
        deadline never admits, an in-slot one is cancelled (``done`` set
        so an in-flight chunk's collect skips it; the slot's table row
        goes back to the sentinel behind that chunk on the stream and
        its pages return, as ``cancel`` does), and a piecewise admission
        drops its pages. Returns them marked ``expired`` and ``done``;
        ``step`` returns them with its finished requests."""
        now = time.monotonic()
        expired: List[_Request] = []
        keep = []
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                expired.append(req)
            else:
                keep.append(req)
        if expired:
            self._queue[:] = keep
        queued_expired = len(expired)
        for slot, req in list(self._slots.items()):
            if req.deadline is not None and now > req.deadline:
                req.done = True
                del self._slots[slot]
                self._free_slot(slot)
                expired.append(req)
        a = self._admitting
        if (a is not None and a["req"].deadline is not None
                and now > a["req"].deadline):
            expired.append(a["req"])
            self._drop_admitting()
        for req in expired:
            req.expired = True
            req.done = True
            if req.span is not None:
                req.span.event("terminal", rid=req.rid, outcome="deadline",
                               new_tokens=len(req.tokens))
        if expired:
            self._n_deadline_expired += len(expired)
            self._obs["serve_request_deadline_exceeded_total"].inc(
                len(expired))
            if queued_expired:
                # expired before any device work: a shed
                self._obs["serve_requests_rejected_total"].labels(
                    reason="deadline").inc(queued_expired)
        return expired

    # -- queue introspection (the serving front's admission bounds) -------
    def queue_depth(self, tenant: Optional[str] = None) -> int:
        """Requests waiting for a slot (``tenant``: that subqueue's)."""
        if tenant is None:
            return len(self._queue)
        return sum(1 for r in self._queue if r.tenant == tenant)

    def queued_tokens(self, tenant: Optional[str] = None) -> int:
        """Prompt + budget tokens of the queued requests (``tenant``:
        that subqueue's) — the bound ``max_queued_tokens`` sheds on."""
        return sum(_request_cost(r) for r in self._queue
                   if tenant is None or r.tenant == tenant)

    def queue_delay_ms(self) -> float:
        """Age of the oldest queued request in ms (0 when none)."""
        if not self._queue:
            return 0.0
        oldest = min(r.enqueued_at for r in self._queue)
        return max(0.0, (time.monotonic() - oldest) * 1000.0)

    def tenant_stats(self) -> Dict[str, dict]:
        """Per tenant: queued requests and tokens, and the cumulative
        admitted token cost (what the DWRR shares converge over)."""
        out: Dict[str, dict] = {}
        blank = {"queued": 0, "queued_tokens": 0, "admitted_tokens": 0}
        for r in self._queue:
            t = out.setdefault(r.tenant, dict(blank))
            t["queued"] += 1
            t["queued_tokens"] += _request_cost(r)
        for tenant, adm in self._fair.admitted_tokens.items():
            out.setdefault(tenant, dict(blank))["admitted_tokens"] = int(adm)
        return out

    # -- the decode chunk on the device -----------------------------------
    def _chunk_async(self, size: int, sampling: bool):
        """Run one decode chunk without reading it back: ``(tokens,
        live, event)`` (``SlotDeviceState.chunk_async``: on CUDA the
        captured graph replays, or the body launches eagerly under a
        gloo tp group, and the outputs are copied into fresh pinned host
        buffers behind ``event``; the CPU runs the body and ``event`` is
        None)."""
        return self._device.chunk_async(size, self.eos_token_id,
                                        self.pad_id, sampling)

    def _spec_async(self, rounds: int, sampling: bool):
        """Run one spec chunk without reading it back: ``(packed,
        event)``, as :meth:`_chunk_async`."""
        return self._device.spec_chunk_async(rounds, self.eos_token_id,
                                             self.pad_id, sampling)

    @property
    def graph_capture_seconds(self) -> Dict[tuple, float]:
        """Warm-up + capture wall time of each captured chunk graph, by
        ``(size, sampling)`` or, for spec chunks, ``(rounds, k,
        sampling)`` (empty on the CPU)."""
        return {key: g.capture_s for key, g in self._graphs.items()}

    def _admission_event(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    # -- the loop --------------------------------------------------------
    def _phase(self, name: str):
        rec = self._step_rec
        return rec.phase(name) if rec is not None else (
            contextlib.nullcontext())

    def _dispatch_chunk(self, size: int) -> _InflightStep:
        """Dispatch one ``size``-step decode chunk (a spec engine: a
        ``size``-round spec chunk) over the current slots; returns the
        in-flight record (result handles and the slot->request snapshot
        the chunk was computed over)."""
        # chaos: a failed (raise) or hung (sleep, with the driver loop's
        # lock held) device step, on the host before the dispatch or the
        # graph replay, never inside a captured region
        chaos_fire("engine.device_step")
        sampling = any(r.temperature > 0 for r in self._slots.values())
        if self._step_rec is not None:
            self._step_rec.decode_slots = max(self._step_rec.decode_slots,
                                              len(self._slots))
        if self._spec:
            return self._dispatch_spec(size, sampling)
        self._n_dispatched_steps += size
        # t_dispatch stamps the dispatch-call ENTRY
        t0 = time.monotonic()
        with torch.no_grad():
            toks, live, event = self._announced(
                lambda wire: wire.announce_cb_chunk(
                    self.num_slots, size, self.eos_token_id, self.pad_id,
                    sampling=sampling, deferred=bool(self.pipeline_depth)),
                lambda: self._chunk_async(size, sampling))
        return _InflightStep("dev", toks, live, event, dict(self._slots),
                             size, t0)

    def _spec_rounds(self, size: int, cap: Optional[int]) -> int:
        """Draft/verify rounds of one spec dispatch. ``size`` bounds the
        EMITTED tokens a slot (the fixed or adaptive chunk); ``cap`` (the
        step-token budget) bounds the device WORK a slot — a round costs
        ~2k+2 forward tokens (k+1 draft feeds, the k+1-wide verify), so
        draft and verify tokens both count. A power of two (a small graph
        set), at least 1."""
        k = self.spec_tokens
        r = max(1, size // (k + 1))
        if cap is not None:
            r = min(r, max(1, cap // (2 * k + 2)))
        b = 1
        while b * 2 <= r:
            b *= 2
        return b

    def _dispatch_spec(self, rounds: int, sampling: bool) -> _InflightStep:
        """Dispatch one ``rounds``-round spec chunk over the current
        slots (one replayed graph on CUDA); its packed result comes back
        at the collect."""
        k = self.spec_tokens
        # device work: (k+1) draft feeds + (k+1) verify positions a
        # round, + the entry/exit feeds
        self._n_dispatched_steps += rounds * (2 * k + 2) + 2
        self._n_spec_rounds += rounds
        if self._step_rec is not None:
            self._step_rec.spec_rounds += rounds
        t0 = time.monotonic()
        with torch.no_grad():
            packed, event = self._announced(
                lambda wire: wire.announce_cb_chunk(
                    self.num_slots, rounds, self.eos_token_id, self.pad_id,
                    sampling=sampling, deferred=bool(self.pipeline_depth),
                    spec_tokens=k),
                lambda: self._spec_async(rounds, sampling))
        return _InflightStep("spec_dev", packed, None, event,
                             dict(self._slots), 1 + rounds * (k + 1), t0)

    def _spec_slot_stream(self, spec_data, slot: int, req: _Request):
        """One slot's tokens from a spec chunk: the entry token, then each
        round's window up to its valid length. Tallies proposed/accepted
        onto the request while it still had budget (overshoot rounds
        must not bias acceptance)."""
        entry, windows, wlens, accepted, proposed, _live = spec_data
        stream = [int(entry[slot])]
        prop = acc = 0
        for r in range(windows.shape[0]):
            if (int(proposed[r, slot])
                    and len(req.tokens) + len(stream) < req.max_new_tokens):
                prop += int(proposed[r, slot])
                acc += int(accepted[r, slot])
            n = int(wlens[r, slot])
            if n:
                stream.extend(int(t) for t in windows[r, :n, slot])
        req.spec_proposed += prop
        req.spec_accepted += acc
        return np.asarray(stream, np.int64), prop, acc

    def _note_spec_stats(self, proposed: int, accepted: int) -> None:
        if not proposed:
            return
        self._n_spec_proposed += proposed
        self._n_spec_accepted += accepted
        self._spec_window.append((proposed, accepted))
        self._obs["serve_spec_proposed_total"].inc(proposed)
        self._obs["serve_spec_accepted_total"].inc(accepted)
        self._obs["serve_spec_accept_rate"].set(self.spec_accept_rate())

    def spec_accept_rate(self) -> float:
        """Draft acceptance over the last 64 collected spec chunks (0.0
        when speculation is off or nothing was decoded yet)."""
        prop = sum(p for p, _ in self._spec_window)
        acc = sum(a for _, a in self._spec_window)
        return acc / prop if prop else 0.0

    def _note_retired(self, fs: _InflightStep, t_retire: float) -> None:
        """Stamp a record's retire time (once) and feed its
        [dispatch, retire] device-busy interval to the stats ring."""
        if fs.t_retire is not None:
            return
        fs.t_retire = t_retire
        self.stepstats.note_device_interval(fs.t_dispatch, fs.t_retire)

    def poll_retire(self) -> None:
        """Non-blocking retire sweep: every in-flight chunk and admission
        whose event completed gets its retire time stamped now."""
        now = time.monotonic()
        for fs in self._inflight_q:
            if fs.t_retire is None and fs.poll_ready():
                self._note_retired(fs, now)
        # admissions complete in dispatch order (one stream)
        while self._admit_q and self._admit_q[0].poll_ready():
            self._note_retired(self._admit_q.popleft(), now)

    def _collect(self, inflight: _InflightStep) -> List[_Request]:
        """Settle one dispatched chunk: wait for its host copy (blocks
        only if it is still computing) and do the host bookkeeping —
        token append, eos/budget completion, trie adoption, frees — for
        the slot snapshot it was computed over."""
        with self._phase("device_wait"):
            if self.announce and self.pipeline_depth:
                # a deferred chunk: the workers settle theirs in step
                toks, live_host = self._announced(
                    lambda wire: wire.announce_cb_collect(self.num_slots),
                    inflight.fetch)
            else:
                toks, live_host = inflight.fetch()
        spec_data = None
        if inflight.kind == "spec_dev":
            spec_data = _unpack_spec(toks, self.spec_tokens)
            live_host = spec_data[-1]
        self._note_retired(inflight, time.monotonic())
        if self._step_rec is not None:
            self._step_rec.device_busy_ms += (
                inflight.t_retire - inflight.t_dispatch) * 1000.0
        newly_done = []
        useful = chunk_prop = chunk_acc = 0
        now = time.monotonic()
        for slot, req in inflight.snapshot.items():
            if req.done:
                # freed or cancelled while this chunk was in flight
                # (decode-ahead): its rows decoded what nobody reads
                continue
            budget = req.max_new_tokens - len(req.tokens)
            if spec_data is not None:
                row, prop, acc = self._spec_slot_stream(spec_data, slot, req)
                chunk_prop += prop
                chunk_acc += acc
                take = row[:budget]
            else:
                take = toks[slot, :budget]
            if self.eos_token_id is not None:
                hit = np.nonzero(take == self.eos_token_id)[0]
                if hit.size:
                    take = take[:hit[0] + 1]
            new_toks = [int(t) for t in take]
            useful += len(new_toks)
            if new_toks:
                # time between token deliveries to one request, as its
                # client sees them (a chunk lands as one delivery)
                if req.last_emit is not None:
                    self._obs["serve_tbt_ms"].observe(
                        (now - req.last_emit) * 1000.0)
                if req.span is not None:
                    if req.last_emit is None:
                        req.span.event(
                            "first_token", rid=req.rid,
                            ttft_ms=round((now - req.enqueued_at) * 1000.0,
                                          3))
                    else:
                        req.span.event("tokens", rid=req.rid,
                                       n=len(new_toks))
                req.last_emit = now
            req.tokens.extend(new_toks)
            if req.on_tokens is not None and new_toks:
                try:
                    req.on_tokens(new_toks)
                except Exception:  # noqa: BLE001 — a broken consumer
                    # must not take the engine down
                    logger.exception(
                        "on_tokens callback failed for request %d", req.rid)
            eos_done = self.eos_token_id is not None and not live_host[slot]
            if eos_done or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                newly_done.append(req)
                if req.span is not None:
                    if req.spec_proposed:
                        # the request's speculation quality on its trace
                        req.span.event(
                            "spec", rid=req.rid, proposed=req.spec_proposed,
                            accepted=req.spec_accepted,
                            accept_rate=round(
                                req.spec_accepted / req.spec_proposed, 4))
                    req.span.event("terminal", rid=req.rid, outcome="ok",
                                   new_tokens=len(req.tokens))
                if self._slots.get(slot) is req:
                    del self._slots[slot]
                if self.radix is not None:
                    # completed prefixes stay resident: adopt the slot's
                    # pages BEFORE the slot's refs drop
                    self._radix_insert(slot, req)
                self._free_slot(slot)
        self._n_finished += len(newly_done)
        if spec_data is not None:
            self._note_spec_stats(chunk_prop, chunk_acc)
        if self._step_rec is not None:
            self._step_rec.tokens_out += useful
        if useful:
            self._obs["serve_useful_tokens_total"].inc(useful)
        self._obs["serve_slots_active"].set(len(self._slots))
        self._obs["serve_queue_depth"].set(len(self._queue))
        if self.paged:
            self._obs["serve_kv_pages_in_use"].set(
                self.model.cfg.kv_num_pages - len(self._free_pages))
        return newly_done

    def _effective_chunk(self) -> int:
        """Size of the next dispatch. Fixed mode: ``chunk``. Adaptive:
        the largest power of two (floored at ``_MIN_ADAPTIVE_CHUNK``,
        capped at ``chunk``) that does not overshoot the smallest
        remaining per-slot budget, counting steps already dispatched but
        not collected; 0 when every live slot's budget is covered by
        in-flight chunks."""
        if not self.adaptive_chunk or not self._slots:
            return self.chunk
        pending: Dict[int, int] = {}
        for fs in self._inflight_q:
            for slot, sreq in fs.snapshot.items():
                if self._slots.get(slot) is sreq:
                    pending[slot] = pending.get(slot, 0) + fs.size
        remaining = min(
            req.max_new_tokens - len(req.tokens) - pending.get(slot, 0)
            for slot, req in self._slots.items())
        if remaining <= 0:
            return 0
        c = min(remaining, self.chunk)
        b = _MIN_ADAPTIVE_CHUNK  # a sub-minimum remainder overshoots by
        while b * 2 <= c:        # < _MIN_ADAPTIVE_CHUNK steps; the
            b *= 2               # collect's budget clamp discards it
        return min(b, self.chunk)

    def _budget_cap(self, prefill_tokens: int) -> Optional[int]:
        """Decode steps the step-token budget leaves after this step's
        prefill pieces: (budget - pieces) / live slots, bucketed DOWN to
        a power of two and floored at 1 (the budget bounds the stall, it
        never stops token flow). None = budget off."""
        if not self.step_token_budget:
            return None
        live = max(len(self._slots), 1)
        steps = max((self.step_token_budget - int(prefill_tokens)) // live,
                    1)
        b = 1
        while b * 2 <= steps:
            b *= 2
        return b

    def step(self) -> List[_Request]:
        """Expire requests past their deadline, run the in-flight
        admission's next piece, admit into free slots, dispatch one
        decode chunk (capped by the step-token budget, sized by
        ``adaptive_chunk``) and collect the chunk ``pipeline_depth``
        steps behind. Returns the requests expired here (``expired``
        set) and those finished in the chunks collected. Every step that
        did work closes exactly one record into ``stepstats`` ("error"
        when it raises)."""
        rec = self.stepstats.begin(queue_depth=len(self._queue))
        self._step_rec = rec
        try:
            finished = self._step_body(rec)
        except BaseException:
            self.stepstats.close(rec, outcome="error")
            raise
        finally:
            self._step_rec = None
        if rec.activity:
            self.stepstats.close(rec)
        else:
            self.stepstats.discard(rec)  # idle spin: no record
        return finished

    def _admission_marker(self) -> tuple:
        return (self._n_prefill_tokens, self._n_batch_admits,
                self._n_solo_admits)

    def _step_body(self, rec) -> List[_Request]:
        # chunks that finished while the host was away get their busy
        # intervals closed before this step's host work
        self.poll_retire()
        with rec.phase("expire"):
            expired = self._expire_deadlines()
        rec.expired = len(expired)
        self._step_prefill_tokens = 0
        pieces0 = self._n_prefill_chunks
        marker0 = self._admission_marker()
        t_sched = time.monotonic()
        with rec.phase("schedule"):
            if self._admitting is not None:
                self._advance_admission()
            self._admit_waiting()
        if self._admission_marker() != marker0:
            # the admission's prefill forwards are device work too
            self._admit_q.append(_InflightStep(
                "admit", None, None, self._admission_event(), {}, 0,
                t_sched))
        rec.prefill_pieces = self._n_prefill_chunks - pieces0
        rec.prefill_tokens = self._step_prefill_tokens
        self._obs["serve_prefill_inflight"].set(
            1 if self._admitting is not None else 0)
        cap = self._budget_cap(self._step_prefill_tokens)
        if not self.pipeline_depth:
            if not self._slots:
                return expired
            size = self._effective_chunk() or self.chunk
            if self._spec:
                # size bounds emitted tokens, cap bounds device work
                # (draft and verify both count)
                size = self._spec_rounds(size, cap)
            elif cap:
                size = min(size, cap)
            with rec.phase("dispatch"):
                inflight = self._dispatch_chunk(size)
            with rec.phase("collect"):
                return expired + self._collect(inflight)
        dispatched = False
        if self._slots:
            size = self._effective_chunk()
            if size and self._spec:
                size = self._spec_rounds(size, cap)
            elif size and cap:
                size = min(size, cap)
            if size:  # 0 = every slot's budget is already in flight
                with rec.phase("dispatch"):
                    self._inflight_q.append(self._dispatch_chunk(size))
                dispatched = True
        finished = list(expired)
        # Drain to the target depth: with live slots exactly one collect
        # a step; with every slot idle the whole backlog flushes now (no
        # later step is guaranteed); a step that dispatched nothing
        # (adaptive, budgets in flight) collects one, or
        # run_until_drained would livelock.
        while (len(self._inflight_q) > self.pipeline_depth
               or (self._inflight_q and not self._slots)
               or (self._inflight_q and not dispatched)):
            with rec.phase("collect"):
                finished += self._collect(self._inflight_q.popleft())
            if self._slots:
                break
        # the chunk dispatched THIS step often finishes during the settle
        self.poll_retire()
        return finished

    def quiesce(self) -> List[_Request]:
        """Settle EVERY in-flight chunk (device sync + full host
        bookkeeping) without dispatching new work; returns the requests
        that finished in the flush. Idempotent."""
        finished: List[_Request] = []
        while self._inflight_q:
            finished += self._collect(self._inflight_q.popleft())
        return finished

    def run_until_drained(self):
        """Drive steps until queue, admission, slots and the pipeline
        are empty; yields finished ``(rid, tokens)`` in completion
        order."""
        while self.busy:
            for req in self.step():
                yield req.rid, req.tokens

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._slots
                    or self._admitting is not None or self._inflight_q)

    def fail_outstanding(self, outcome: str = "error") -> List[_Request]:
        """Mark every accepted, undelivered request terminally failed: its
        one terminal span event (``outcome``: "error" for a rebuild after
        a failed or hung step, "shed" for a reload past its drain bound)
        and ``done``, so no later path delivers it. Returns them for the
        front to settle; no device work (the engine is being dropped)."""
        out = self.outstanding_requests()
        for req in out:
            self._trace_terminal(req, outcome)
            req.done = True
        return out

    def outstanding_requests(self) -> List[_Request]:
        """Every accepted, undelivered request: queued, admitting, in a
        slot, or held only by an in-flight chunk's snapshot."""
        out: List[_Request] = []
        seen = set()

        def add(req):
            if not req.done and id(req) not in seen:
                seen.add(id(req))
                out.append(req)

        for req in self._queue:
            add(req)
        if self._admitting is not None:
            add(self._admitting["req"])
        for req in self._slots.values():
            add(req)
        for fs in self._inflight_q:
            for req in fs.snapshot.values():
                add(req)
        return out

    @property
    def stats(self) -> dict:
        cfg = self.model.cfg
        return {
            "queued": len(self._queue),
            "queued_tokens": self.queued_tokens(),
            "queue_delay_ms": round(self.queue_delay_ms(), 2),
            "tenants": self.tenant_stats(),
            "fair_active": self._fair_active,
            "active": len(self._slots),
            "finished": self._n_finished,
            "deadline_expired": self._n_deadline_expired,
            "num_slots": self.num_slots,
            "chunk": self.chunk,
            "batch_admits": self._n_batch_admits,
            "solo_admits": self._n_solo_admits,
            "dispatched_steps": self._n_dispatched_steps,
            "prefill_chunks": self._n_prefill_chunks,
            "prefill_tokens_computed": self._n_prefill_tokens,
            "step_phases": self.stepstats.summary(),
            **({"step_token_budget": self.step_token_budget}
               if self.step_token_budget else {}),
            **({"spec": {
                "spec_tokens": self.spec_tokens,
                "rounds": self._n_spec_rounds,
                "proposed": self._n_spec_proposed,
                "accepted": self._n_spec_accepted,
                "accept_rate": round(self._n_spec_accepted
                                     / max(self._n_spec_proposed, 1), 4),
                "recent_accept_rate": round(self.spec_accept_rate(), 4),
                "self_draft": self._self_draft,
            }} if self._spec else {}),
            "admitting": (self._admitting["req"].rid
                          if self._admitting is not None else None),
            "inflight": bool(self._inflight_q),
            "pipeline_depth": self.pipeline_depth,
            "decode_graphs": len(self._graphs),
            "captured": self.captured,
            **({"prefix_cache": self.prefix_cache.stats}
               if self.prefix_cache is not None else
               {"prefix_cache": self.radix.stats}
               if self.radix is not None else {}),
            **({"paged": {
                "page_size": cfg.kv_page_size,
                "pages_total": cfg.kv_num_pages,
                "pages_in_use": cfg.kv_num_pages - len(self._free_pages),
                "peak_pages_in_use": self._peak_pages_in_use,
                "page_alloc_failures": self._n_page_alloc_failures,
                "page_bytes_per_layer": self._page_bytes_per_layer,
            }} if self.paged else {}),
        }
