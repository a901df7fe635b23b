"""Slot-based continuous batching over a paged KV pool (the core of
``pyspark_tf_gke_tpu/train/continuous.py``).

A fixed pool of ``num_slots`` request slots decodes together; requests
arrive and finish at different times and every free slot is refilled
at the next chunk boundary. Admission prefills prompts right-padded to
a length bucket (exact under causal attention: no real token sees the
padding after it), batching the FIFO prefix of the queue that shares a
bucket into ONE forward, and scatters the dense prefill K/V into the
pages the engine allocated for each slot. A decode chunk runs ``chunk``
slot-decode steps in the emit-then-step order of ``generate``: emit
token t from the carried logits, then run the model at each row's own
position. Dead rows (free slot, or past eos) keep computing with a pad
token at their FROZEN position; their emitted tokens are ``pad_id``.

The engine owns the page pool on the host: a free list plus refcounts,
allocation at admission and release at finish — no allocation inside
a chunk. A freed slot's block-table row goes back to the sentinel, so
its dead-row writes can never land in pages handed to another request.

Chunked prefill (``prefill_chunk``): a prompt longer than
``prefill_chunk`` admits piecewise, one ``prefill_chunk``-wide piece a
step, each written straight into the page pool through the admission's
own page row (``_paged_prefill_chunk``) while the reserved slot's table
row stays at the sentinel; decode chunks run between the pieces, so a
long arrival stalls the streaming slots by one piece, not a whole
prefill. ``step_token_budget`` caps one step's work (the piece plus
live slots x decode steps) by shrinking the decode chunk
(``_budget_cap``).

This slice's engine is serial (``pipeline_depth=0``): one chunk is
dispatched and collected per ``step``, with one device-to-host copy per
chunk. The attribute names ``_queue``, ``_slots``, ``_admitting``,
``_inflight_q``, ``_page_refs``, ``_free_pages``, ``_slot_pages`` and
``radix`` match the JAX engine so its invariant checker can run here.
Sampled lanes draw from a per-slot ``torch.Generator`` seeded from the
request's ``seed``: deterministic per (prompt, seed), not bit-equal to
JAX's threefry stream.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM, DenseCache,
                                                       PagedKV,
                                                       _filter_logits,
                                                       gumbel_argmax)

PAD_BUCKETS = (32, 64, 128, 256, 512, 1024)

# engine options of the JAX engine this slice does not carry, with the
# ROADMAP item (queue 1) that brings each
_NOT_PORTED = {
    "prefix_cache_size": "P4 radix prefix cache",
    "pipeline_depth": "P5 async step pipeline",
    "adaptive_chunk": "P5 async step pipeline",
    "spec_tokens": "P6 in-engine speculative decoding",
    "draft_model": "P6 in-engine speculative decoding",
    "tenant_weights": "P7 tenants and deadlines",
}


def bucket_length(n: int, buckets: Sequence[int] = PAD_BUCKETS) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # [S_true] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    temperature: float = 0.0      # 0 = greedy
    top_p: Optional[float] = None
    seed: int = 0


class SlotState:
    """The slot pool's device state (``_paged_zeros_state``): the paged
    cache, per-slot fill levels, carried logits, live flags and sampling
    lanes. Mutated in place by the functions below."""

    def __init__(self, model: CausalLM, num_slots: int,
                 device: torch.device):
        cfg = model.cfg
        self.cache = PagedKV(cfg, num_slots, device)
        self.positions = torch.zeros(num_slots, dtype=torch.long,
                                     device=device)
        self.last_logits = torch.zeros(num_slots, cfg.vocab_size,
                                       device=device)
        self.live = torch.zeros(num_slots, dtype=torch.bool, device=device)
        self.temps = torch.zeros(num_slots, device=device)
        self.topps = torch.ones(num_slots, device=device)
        self.generators: List[Optional[torch.Generator]] = [None] * num_slots


def _slot_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def _prefill_padded_batch(model: CausalLM, padded: np.ndarray,
                          true_lens: np.ndarray):
    """Right-padded prefill of ``[k, S_bucket]`` prompts in ONE forward.
    Returns the dense ``[k, S_bucket]`` cache and the logits at each
    row's last real token ``[k, V]``."""
    device = model.device
    ids = torch.from_numpy(padded).to(device=device, dtype=torch.long)
    last = torch.from_numpy(true_lens.astype(np.int64) - 1).to(device)
    cache = DenseCache(model.cfg, padded.shape[0], padded.shape[1], device)
    logits = model(ids, cache=cache, prefill=True, last_index=last)
    return cache, logits[:, 0]


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
    idx = torch.from_numpy(
        np.ascontiguousarray(pages_b[:, :nc]).reshape(-1)).to(device)
    for layer in range(len(caches.k)):
        def chunks(t):
            rows = t[:, :n_rows]
            return rows.reshape((k_rows * nc, ps) + tuple(rows.shape[2:]))
        scales = ((chunks(caches.k_scale[layer]),
                   chunks(caches.v_scale[layer]))
                  if caches.k_scale is not None else (None, None))
        kv.write_pages(layer, idx, chunks(caches.k[layer]),
                       chunks(caches.v[layer]), *scales)
    slot_idx = torch.tensor(slots, dtype=torch.long, device=device)
    kv.block_table[slot_idx] = torch.from_numpy(pages_b).to(device)
    state.positions[slot_idx] = torch.from_numpy(
        fills.astype(np.int64)).to(device)
    state.last_logits[slot_idx] = logits
    state.live[slot_idx] = True
    state.temps[slot_idx] = torch.tensor([s[0] for s in samplings],
                                         dtype=torch.float32, device=device)
    state.topps[slot_idx] = torch.tensor([s[1] for s in samplings],
                                         dtype=torch.float32, device=device)
    for slot, (temp, _, seed) in zip(slots, samplings):
        state.generators[slot] = (_slot_generator(seed, device) if temp > 0
                                  else None)


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
    device = model.device
    w = padded.shape[0]
    ids = torch.from_numpy(padded[None].astype(np.int64)).to(device)
    positions = (fill + torch.arange(w, device=device))[None]
    view = state.cache.with_table(torch.from_numpy(row[None]).to(device))
    last = torch.tensor([true_len - 1], device=device)
    return model(ids, positions=positions, cache=view, last_index=last)[:, 0]


def _activate_slot_paged(state: SlotState, slot: int, row: np.ndarray,
                         fill: int, logits1: torch.Tensor,
                         sampling: tuple) -> None:
    """Chunked-prefill admission complete: point the slot's block-table
    row at the admission's pages (every piece already lives in them) and
    flip the slot live with its fill level, carried logits and sampling
    lane — no cache rows to move."""
    device = logits1.device
    temp, topp, seed = sampling
    state.cache.block_table[slot] = torch.from_numpy(row).to(device)
    state.positions[slot] = fill
    state.last_logits[slot] = logits1[0]
    state.live[slot] = True
    state.temps[slot] = temp
    state.topps[slot] = topp
    state.generators[slot] = (_slot_generator(seed, device) if temp > 0
                              else None)


def _clear_live_paged(state: SlotState, slot: int) -> None:
    """Paged free: drop the live flag AND reset the slot's block-table
    row to the sentinel."""
    state.cache.block_table[slot] = state.cache.num_pages
    state.live[slot] = False
    state.generators[slot] = None


def _pick_tokens(logits: torch.Tensor, state: SlotState,
                 sampling_rows: Sequence[int]) -> torch.Tensor:
    """[B] next tokens: greedy rows argmax; each sampling row draws from
    its temperature-scaled, top-p-filtered distribution with its own
    generator."""
    tok = torch.argmax(logits, dim=-1)
    for row in sampling_rows:
        scaled = logits[row:row + 1] / state.temps[row].clamp_min(1e-6)
        filtered = _filter_logits(scaled, None, state.topps[row])
        tok[row] = gumbel_argmax(filtered, state.generators[row])[0]
    return tok


def _decode_chunk(model: CausalLM, state: SlotState, chunk: int,
                  eos_token_id: Optional[int], pad_id: int,
                  sampling_rows: Sequence[int]) -> torch.Tensor:
    """``chunk`` decode steps for ALL slots; returns the emitted tokens
    ``[B, chunk]`` (on the device) and updates ``state`` in place."""
    emitted_steps = []
    for _ in range(chunk):
        tok = _pick_tokens(state.last_logits, state, sampling_rows)
        live = state.live
        # emit BEFORE the eos latch drops `live`: the eos token itself
        # belongs to the output
        emitted_steps.append(torch.where(live, tok, pad_id))
        if eos_token_id is not None:
            live = live & (tok != eos_token_id)
        # dead rows replay their FROZEN position with a pad token
        step_tok = torch.where(live, tok, pad_id)
        logits = model(step_tok[:, None], positions=state.positions[:, None],
                       cache=state.cache)
        state.positions = torch.where(live, state.positions + 1,
                                      state.positions)
        state.last_logits = logits[:, 0]
        state.live = live
    return torch.stack(emitted_steps, dim=1)


class ContinuousEngine:
    """Admit requests any time; every free KV slot is refilled at the
    next chunk boundary. ``submit`` queues, ``run_until_drained`` (or
    repeated ``step``) decodes; finished requests come back as
    ``(rid, token_list)``. The model must be paged
    (``CausalLMConfig.kv_num_pages``)."""

    def __init__(self, model: CausalLM, num_slots: int = 8, chunk: int = 8,
                 eos_token_id: Optional[int] = None, pad_id: int = 0,
                 buckets: Sequence[int] = PAD_BUCKETS,
                 prefill_chunk: int = 0, step_token_budget: int = 0,
                 **unported):
        for name, value in unported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected engine option {name!r}")
            if value:
                raise NotImplementedError(
                    f"engine option {name}={value!r} is not ported yet "
                    f"(ROADMAP queue 1, {_NOT_PORTED[name]})")
        cfg = model.cfg
        if not cfg.paged_kv:
            raise NotImplementedError(
                "the dense slot-cache engine is not ported yet (ROADMAP "
                "queue 1, dense slot-cache engine); use a bundle with "
                "kv_num_pages")
        if num_slots < 1 or chunk < 1:
            raise ValueError("num_slots and chunk must be >= 1")
        if prefill_chunk and prefill_chunk < 32:
            raise ValueError(
                f"prefill_chunk must be 0 (off) or >= 32, got "
                f"{prefill_chunk} (tiny pieces spend more dispatches "
                "than they save)")
        if step_token_budget < 0:
            raise ValueError(
                f"step_token_budget must be >= 0, got {step_token_budget}")
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
        if s_max % ps:
            raise ValueError(f"kv_page_size {ps} must divide max_seq_len "
                             f"{s_max}")
        if buckets is PAD_BUCKETS:
            buckets = tuple(b for b in PAD_BUCKETS if b < s_max) + (s_max,)
        # prefill rows scatter whole pages: every bucket is page-aligned
        self.buckets = tuple(b for b in buckets if b <= s_max and b % ps == 0)
        if not self.buckets:
            raise ValueError(f"no prompt bucket fits max_seq_len {s_max} as "
                             f"a multiple of kv_page_size {ps}")
        self._free_pages: List[int] = list(range(cfg.kv_num_pages))
        self._page_refs: Dict[int, int] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._peak_pages_in_use = 0
        self._n_page_alloc_failures = 0
        self._rid = itertools.count()
        self._queue: List[_Request] = []
        self._slots: Dict[int, _Request] = {}
        self._admitting: Optional[dict] = None  # the piecewise admission
        self._inflight_q: Deque = deque()  # decode-ahead: not ported
        self.radix = None                 # radix prefix cache: not ported
        self._n_finished = 0
        self._n_batch_admits = 0
        self._n_solo_admits = 0
        self._n_dispatched_steps = 0
        self._n_prefill_tokens = 0
        self._n_prefill_chunks = 0     # pieces processed
        self._step_prefill_tokens = 0  # this step's piece tokens
        self._state = SlotState(model, num_slots, self.device)

    # -- submission ------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, top_p: Optional[float] = None,
               seed: int = 0, deadline_s: Optional[float] = None) -> int:
        if deadline_s is not None:
            raise NotImplementedError(
                "request deadlines are not ported yet (ROADMAP queue 1, P7 "
                "tenants and deadlines)")
        if temperature and temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
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
        else:
            sb = bucket_length(prompt.size, self.buckets)
            need = self._pages_needed(sb, prompt.size, max_new_tokens)
        if need > cfg.kv_num_pages:
            # with the whole pool free it still could not admit —
            # queueing it would livelock run_until_drained
            raise ValueError(
                f"request needs {need} KV pages but the pool has "
                f"{cfg.kv_num_pages} (page_size {cfg.kv_page_size})")
        req = _Request(next(self._rid), prompt, int(max_new_tokens),
                       temperature=float(temperature or 0.0), top_p=top_p,
                       seed=int(seed))
        self._queue.append(req)
        return req.rid

    def _chunked_route(self, prompt_len: int) -> bool:
        return bool(self.prefill_chunk and prompt_len > self.prefill_chunk)

    def cancel(self, rid: int) -> bool:
        """Drop a queued request, free the slot of an active one, or
        abandon the piecewise admission of one (its pages return)."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                req.done = True
                del self._queue[i]
                return True
        for slot, req in list(self._slots.items()):
            if req.rid == rid:
                req.done = True
                del self._slots[slot]
                self._free_slot(slot)
                return True
        if self._admitting is not None and self._admitting["req"].rid == rid:
            self._admitting["req"].done = True
            self._drop_admitting()
            return True
        return False

    # -- page pool (host side) -------------------------------------------
    def _pages_needed(self, s_bucket: int, true_len: int,
                      max_new: int) -> int:
        """Pages covering BOTH the padded prefill scatter (``s_bucket``
        rows land in pages) and the request's maximum token extent."""
        ps = self.model.cfg.kv_page_size
        return -(-max(int(s_bucket), int(true_len) + int(max_new)) // ps)

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

    def _take_pages(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages (refcount 1 each), or None."""
        if n > len(self._free_pages):
            return None
        taken = [self._free_pages.pop() for _ in range(n)]
        for p in taken:
            self._page_refs[p] = 1
        used = self.model.cfg.kv_num_pages - len(self._free_pages)
        self._peak_pages_in_use = max(self._peak_pages_in_use, used)
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
        _clear_live_paged(self._state, slot)
        self._release_pages(slot)

    # -- admission -------------------------------------------------------
    def _device_admit(self, group: List[_Request], slots: List[int],
                      sb: int, pages_b: np.ndarray) -> None:
        """ONE batched prefill + ONE scatter admits ``group``."""
        padded = np.full((len(group), sb), self.pad_id, np.int32)
        lens = np.zeros((len(group),), np.int32)
        for i, req in enumerate(group):
            padded[i, :req.prompt.size] = req.prompt
            lens[i] = req.prompt.size
        samplings = [(r.temperature,
                      float(r.top_p if r.top_p is not None else 1.0), r.seed)
                     for r in group]
        with torch.no_grad():
            caches, logits = _prefill_padded_batch(self.model, padded, lens)
            _insert_slots_batch_paged(self._state, caches, logits, slots,
                                      lens, pages_b, samplings, n_rows=sb)
        self._n_prefill_tokens += int(lens.sum())

    def _admit_group(self, group: List[_Request], slots: List[int],
                     sb: int, allocs: List[tuple]) -> None:
        pages_b = np.stack([row for row, _ in allocs])
        try:
            self._device_admit(group, slots, sb, pages_b)
        except BaseException:
            for _, taken in allocs:  # a failed admit must not leak pages
                self._unref_pages(taken)
            raise
        for slot, req, (_, taken) in zip(slots, group, allocs):
            self._slots[slot] = req
            self._slot_pages[slot] = taken

    def _admit_batch(self, free: List[int]) -> None:
        """Batched admission: the FIFO prefix of the queue that shares
        one prompt bucket and fits the pool prefills in one forward. The
        batch stops at the first request needing another bucket, the
        piecewise route or more pages than remain."""
        group: List[_Request] = []
        needs: List[int] = []
        sb0 = None
        pages_left = len(self._free_pages)
        for req in self._queue:
            if len(group) >= len(free):
                break
            if self._chunked_route(req.prompt.size):
                break  # piecewise route
            sb = bucket_length(req.prompt.size, self.buckets)
            if sb0 is None:
                sb0 = sb
            elif sb != sb0:
                break
            need = self._pages_needed(sb, req.prompt.size, req.max_new_tokens)
            if need > pages_left:
                break
            pages_left -= need
            needs.append(need)
            group.append(req)
        if len(group) < 2:
            return
        allocs = [self._alloc_pages(n) for n in needs]  # covered above
        self._admit_group(group, free[:len(group)], sb0, allocs)
        del self._queue[:len(group)]
        self._n_batch_admits += len(group)

    def _try_admit(self, slot: int, req: _Request) -> bool:
        """Admit ``req`` into ``slot``, or START its piecewise (chunked
        prefill) admission; False when the pool cannot cover it yet or a
        piecewise admission is already in flight (FIFO holds; the
        request stays queued)."""
        if self._chunked_route(req.prompt.size):
            if self._admitting is not None:
                return False  # one piecewise admission at a time
            self._start_paged_admission(slot, req)
            return True
        sb = bucket_length(req.prompt.size, self.buckets)
        alloc = self._alloc_pages(self._pages_needed(
            sb, req.prompt.size, req.max_new_tokens))
        if alloc is None:
            return False
        self._admit_group([req], [slot], sb, [alloc])
        return True

    def _start_paged_admission(self, slot: int, req: _Request) -> None:
        """Begin a piecewise paged admission into ``slot`` (reserved from
        here on) and run its first piece."""
        cfg = self.model.cfg
        self._admitting = {
            "slot": slot, "req": req, "fill": 0, "pages": [],
            "row": np.full((cfg.max_pages_per_slot,), cfg.kv_num_pages,
                           np.int32)}
        self._advance_admission()

    def _advance_admission(self) -> None:
        """One piece of the piecewise admission: extend its page
        allocation to cover the piece's real tokens (the final piece
        claims the whole decode extent — nothing is allocated
        mid-decode), write the piece's K/V into the pool, and on the
        final piece activate the slot. Pool dry: the admission stalls (no
        piece; one allocation failure counted a stalled step) and resumes
        after frees."""
        a = self._admitting
        req, fill = a["req"], a["fill"]
        cfg = self.model.cfg
        # near the context limit a full-width piece would run positions
        # past max_seq_len: clamp its width
        w = min(self.prefill_chunk, cfg.max_seq_len - fill)
        piece = req.prompt[fill:fill + w]
        final = fill + piece.size == req.prompt.size
        covered = len(a["pages"])
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
        padded = np.full((w,), self.pad_id, np.int32)
        padded[:piece.size] = piece
        try:
            with torch.no_grad():
                logits1 = _paged_prefill_chunk(self.model, self._state,
                                               padded, fill, piece.size,
                                               a["row"])
                if final:
                    _activate_slot_paged(
                        self._state, a["slot"], a["row"], req.prompt.size,
                        logits1, (float(req.temperature),
                                  float(req.top_p if req.top_p is not None
                                        else 1.0), int(req.seed)))
        except BaseException:
            # a failed piece must not leak the admission's pages (the
            # caller may keep driving this engine), nor lose its request:
            # it goes back to the queue head (a first piece fails while
            # it is still there), so outstanding_requests finds it
            self._drop_admitting()
            if not any(r is req for r in self._queue):
                self._queue.insert(0, req)
            raise
        a["fill"] = fill + piece.size
        self._n_prefill_chunks += 1
        self._step_prefill_tokens += int(piece.size)
        self._n_prefill_tokens += int(piece.size)
        if final:
            self._slots[a["slot"]] = req
            self._slot_pages[a["slot"]] = a["pages"]
            self._admitting = None

    def _drop_admitting(self) -> None:
        """Abandon the piecewise admission (cancel, failed piece): every
        page it holds returns to the pool. The slot's table row was
        never set, so what the pieces wrote is unreachable."""
        a, self._admitting = self._admitting, None
        if a is not None and a["pages"]:
            self._unref_pages(a["pages"])

    def _admit_waiting(self) -> None:
        reserved = (self._admitting["slot"]
                    if self._admitting is not None else None)

        def free_slots():
            return [s for s in range(self.num_slots)
                    if s not in self._slots and s != reserved]

        free = free_slots()
        if (len(free) >= 2 and len(self._queue) >= 2
                and self._admitting is None):
            self._admit_batch(free)
            free = free_slots()
        while free and self._queue:
            if not self._try_admit(free[0], self._queue[0]):
                break  # pool dry / piecewise admission busy
            free.pop(0)
            self._queue.pop(0)
            self._n_solo_admits += 1

    # -- the loop --------------------------------------------------------
    def _run_chunk(self, size: int):
        """Dispatch one ``size``-step chunk over the current slots and
        read it back: ``(tokens [B, size], live [B])`` as numpy."""
        sampling_rows = [slot for slot, req in self._slots.items()
                         if req.temperature > 0]
        self._n_dispatched_steps += size
        with torch.no_grad():
            toks = _decode_chunk(self.model, self._state, size,
                                 self.eos_token_id, self.pad_id,
                                 sampling_rows)
            # the loop's one device-to-host copy per chunk
            return toks.cpu().numpy(), self._state.live.cpu().numpy()

    def _collect(self, toks: np.ndarray, live_host: np.ndarray,
                 snapshot: Dict[int, _Request]) -> List[_Request]:
        """Host bookkeeping for one chunk: token append, eos/budget
        completion, frees."""
        newly_done = []
        for slot, req in snapshot.items():
            budget = req.max_new_tokens - len(req.tokens)
            take = toks[slot, :budget]
            if self.eos_token_id is not None:
                hit = np.nonzero(take == self.eos_token_id)[0]
                if hit.size:
                    take = take[:hit[0] + 1]
            req.tokens.extend(int(t) for t in take)
            eos_done = self.eos_token_id is not None and not live_host[slot]
            if eos_done or len(req.tokens) >= req.max_new_tokens:
                req.done = True
                newly_done.append(req)
                if self._slots.get(slot) is req:
                    del self._slots[slot]
                self._free_slot(slot)
        self._n_finished += len(newly_done)
        return newly_done

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
        """Run the in-flight admission's next piece, admit into free
        slots (a fresh piecewise admission runs its first piece here
        too), run one decode chunk (capped by the step-token budget),
        collect tokens. Returns requests finished during this chunk."""
        self._step_prefill_tokens = 0
        if self._admitting is not None:
            self._advance_admission()
        self._admit_waiting()
        if not self._slots:
            return []
        size = self.chunk
        cap = self._budget_cap(self._step_prefill_tokens)
        if cap:
            size = min(size, cap)
        snapshot = dict(self._slots)
        toks, live_host = self._run_chunk(size)
        return self._collect(toks, live_host, snapshot)

    def run_until_drained(self):
        """Drive steps until queue, admission and slots are empty; yields
        finished ``(rid, tokens)`` in completion order."""
        while self.busy:
            for req in self.step():
                yield req.rid, req.tokens

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._slots
                    or self._admitting is not None)

    def outstanding_requests(self) -> List[_Request]:
        """Every accepted, undelivered request (queued, admitting or in
        a slot)."""
        admitting = ([self._admitting["req"]]
                     if self._admitting is not None else [])
        return ([r for r in self._queue if not r.done]
                + [r for r in admitting if not r.done]
                + [r for r in self._slots.values() if not r.done])

    @property
    def stats(self) -> dict:
        cfg = self.model.cfg
        return {
            "queued": len(self._queue),
            "active": len(self._slots),
            "finished": self._n_finished,
            "num_slots": self.num_slots,
            "chunk": self.chunk,
            "batch_admits": self._n_batch_admits,
            "solo_admits": self._n_solo_admits,
            "dispatched_steps": self._n_dispatched_steps,
            "prefill_chunks": self._n_prefill_chunks,
            "prefill_tokens_computed": self._n_prefill_tokens,
            **({"step_token_budget": self.step_token_budget}
               if self.step_token_budget else {}),
            "admitting": (self._admitting["req"].rid
                          if self._admitting is not None else None),
            "paged": {
                "page_size": cfg.kv_page_size,
                "pages_total": cfg.kv_num_pages,
                "pages_in_use": cfg.kv_num_pages - len(self._free_pages),
                "peak_pages_in_use": self._peak_pages_in_use,
                "page_alloc_failures": self._n_page_alloc_failures,
            },
        }
