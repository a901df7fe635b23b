"""Speculative decoding: a small draft model proposes, the target model
verifies — greedy-exact (counterpart of
``pyspark_tf_gke_tpu/models/speculative.py``).

A cheap draft autoregresses ``gamma`` candidate tokens and the target
scores the whole proposal in ONE chunk forward against its cache; the
accepted prefix plus one correction token are emitted, between 1 and
``gamma + 1`` tokens a target forward. Greedy acceptance (a draft token
is kept while it equals the target's argmax before it) makes the output
the target's own greedy tokens: the draft changes speed, never content.

Cache bookkeeping: both models decode against a :class:`DenseCache`
whose rows past the fill are masked by position, so the fill is just
the position the next feed starts at and ROLLBACK after a rejected
proposal is feeding from the verified prefix again — the stale rows are
invisible and get overwritten (the JAX module's ``_set_cache_index``).

The acceptance rule (:func:`greedy_accept_len`, :func:`emit_window`,
:func:`accept_and_correct`) has one implementation, shared by
:func:`speculative_generate` and the slot engine's spec chunk
(``train/continuous.py``). Sampled lanes draw their uniforms and their
correction from the lane's seed key and step counter
(``models/lanes.py``), so the rule runs inside a captured CUDA graph.

Two drivers of :func:`speculative_generate` share the per-round pieces:

- the **host loop** reads each round's proposal and acceptance back on
  the host (draft resync of the unfed emitted tokens, ``gamma`` greedy
  draft steps, one ``gamma + 1``-wide verify, accept, rollback);
- the **device loop** keeps the whole round on the device: a fixed-width
  round writes its emission window into a device token buffer through a
  masked write, resyncs the draft by rewriting the last ``gamma + 1``
  rows before the fill, and advances nothing once the generation is
  done, so rounds past the end are no-ops. On CUDA the round is captured
  as one CUDA graph and replayed, and the host reads the pinned
  ``(n_emitted, done)`` pair once every :data:`CHECK_EVERY` replays; the
  CPU runs the same round eagerly. Same tokens and same stats as the
  host loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.models import lanes
from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM, DenseCache,
                                                       _filter_logits)

# device-loop rounds replayed between two readbacks of (n_emitted, done)
CHECK_EVERY = 4


# -- THE acceptance rule: one implementation site -------------------------------


def greedy_accept_len(drafts: torch.Tensor,
                      target_picks: torch.Tensor) -> torch.Tensor:
    """Number of leading draft tokens equal to the target's own pick at
    the position before them: ``drafts [..., k]`` against
    ``target_picks [..., k]`` -> ``[...]`` in ``[0, k]``."""
    match = (drafts == target_picks).long()
    return torch.cumprod(match, dim=-1).sum(dim=-1)


def emit_window(drafts: torch.Tensor, correction: torch.Tensor,
                accepted: torch.Tensor) -> torch.Tensor:
    """Fixed-width emission window ``[..., k+1]``: positions below
    ``accepted`` carry the accepted drafts, position ``accepted`` the
    correction/bonus token, and the tail repeats the correction (callers
    mask or overwrite past the frontier)."""
    k = drafts.shape[-1]
    iota = torch.arange(k + 1, device=drafts.device)
    padded = torch.cat([drafts, torch.zeros_like(drafts[..., :1])], dim=-1)
    return torch.where(iota < accepted[..., None], padded,
                       correction[..., None])


def accept_and_correct(drafts: torch.Tensor, draft_logits: torch.Tensor,
                       target_logits: torch.Tensor, *,
                       temps: Optional[torch.Tensor] = None,
                       topps: Optional[torch.Tensor] = None,
                       keys: Optional[torch.Tensor] = None,
                       draws: Optional[torch.Tensor] = None):
    """Batched accept + correct, one rule per sampling lane.

    ``drafts [B, k]`` proposed tokens; ``draft_logits [B, k, V]`` the
    logits each was picked from; ``target_logits [B, k+1, V]`` the verify
    chunk's logits (position i scores the token after feeding draft
    i-1). Returns ``(accepted [B], correction [B])``.

    Greedy rows (``temps == 0``): accept while the draft equals the
    target argmax — exact. Sampled rows: the speculative rejection rule
    (Leviathan et al.): draft ``d_i`` drawn from ``q_i`` is kept while
    ``u * q_i(d_i) < p_i(d_i)``; the first rejection draws the correction
    from ``norm(max(p - q, 0))``, and a fully accepted proposal draws the
    bonus token from ``p_k`` (the q row at k is zero). Temperature and
    top-p shape both distributions alike, so the rule samples the
    filtered target distribution. ``keys`` / ``draws`` (``[B]`` int64,
    the lanes' seed keys and step counters) drive the uniforms and the
    correction draw; ``temps=None`` is an all-greedy pool."""
    k = drafts.shape[-1]
    tgt_pick = torch.argmax(target_logits, dim=-1)
    a_greedy = greedy_accept_len(drafts, tgt_pick[..., :k])
    corr_greedy = torch.take_along_dim(tgt_pick, a_greedy[..., None],
                                       dim=-1)[..., 0]
    if temps is None:
        return a_greedy, corr_greedy

    def dist(logits):
        scaled = logits / temps.clamp_min(1e-6)[:, None, None]
        return torch.softmax(
            _filter_logits(scaled, None, topps[:, None, None]), dim=-1)

    b, _, v = target_logits.shape
    device = target_logits.device
    q = dist(draft_logits)                                   # [B, k, V]
    p_full = dist(target_logits)                             # [B, k+1, V]
    q_d = torch.take_along_dim(q, drafts[..., None], dim=-1)[..., 0]
    p_d = torch.take_along_dim(p_full[:, :k], drafts[..., None],
                               dim=-1)[..., 0]
    u = lanes.uniforms(keys, draws, lanes.ACCEPT,
                       lanes.column_mix(k, device))          # [B, k]
    ok = (u * q_d.clamp_min(1e-20) < p_d).long()
    a_samp = torch.cumprod(ok, dim=-1).sum(dim=-1)
    sel = a_samp[:, None, None].expand(b, 1, v)
    p_a = torch.gather(p_full, 1, sel)[:, 0]                 # [B, V]
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    q_a = torch.gather(q_pad, 1, sel)[:, 0]
    resid = (p_a - q_a).clamp_min(0.0)
    resid = resid / resid.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    noise = lanes.gumbel(keys, draws, lanes.CORRECT,
                         lanes.column_mix(v, device))
    corr_samp = torch.argmax(torch.log(resid.clamp_min(1e-30)) + noise,
                             dim=-1)
    sampled = temps > 0
    return (torch.where(sampled, a_samp, a_greedy),
            torch.where(sampled, corr_samp, corr_greedy))


# -- the per-round pieces ----------------------------------------------------------


def _prefill(model: CausalLM, prompt: torch.Tensor):
    """Dense prefill of ``prompt [B, S]``: the cache (``max_seq_len``
    rows) and the last token's logits ``[B, V]``."""
    b, s = prompt.shape
    cache = DenseCache(model.cfg, b, model.cfg.max_seq_len, model.device,
                       model.kv_cache_heads)
    logits = model(prompt, cache=cache, prefill=True,
                   last_index=torch.full((b,), s - 1, device=model.device))
    return cache, logits[:, 0]


def _extend(model: CausalLM, cache: DenseCache, chunk: torch.Tensor, pos,
            cache_only: bool = False) -> Optional[torch.Tensor]:
    """Feed ``chunk [B, c]`` at positions ``pos .. pos + c - 1`` (``pos``
    an int or a 0-d tensor): its logits ``[B, c, V]``, or None with
    ``cache_only`` (a draft resync reads no logits; the head is skipped)."""
    b, c = chunk.shape
    positions = (pos + torch.arange(c, device=chunk.device))[None].expand(b, c)
    out = model(chunk, positions=positions, cache=cache,
                return_hidden=cache_only)
    return None if cache_only else out


def _draft_propose(model: CausalLM, cache: DenseCache, last_tok: torch.Tensor,
                   pos, gamma: int) -> torch.Tensor:
    """Greedy-autoregress ``gamma`` draft tokens from ``last_tok [B]`` fed
    at ``pos``: ``[B, gamma]``. The cache then holds last_tok ..
    d_{gamma-2} (the final proposal is picked, never fed)."""
    tok, out = last_tok, []
    for t in range(gamma):
        logits = _extend(model, cache, tok[:, None], pos + t)
        tok = torch.argmax(logits[:, 0], dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1)


def _pad_after_eos(out, max_new_tokens: int, eos_token_id: Optional[int]):
    """``generate()``'s output contract: truncate at the first eos and
    pad with it to the fixed length; without eos, repeat the last
    token."""
    if eos_token_id is not None and eos_token_id in out:
        stop = out.index(eos_token_id)
        return out[:stop + 1] + [eos_token_id] * (max_new_tokens - stop - 1)
    return out + [out[-1]] * (max_new_tokens - len(out))


class _RoundState:
    """The device loop's carried state: the token buffer (prompt, first
    token, then each round's window) and the 0-d counters."""

    def __init__(self, prompt: torch.Tensor, first: torch.Tensor, length: int,
                 eos_token_id: Optional[int]):
        device = prompt.device
        s = prompt.shape[1]
        self.toks = torch.zeros(length, dtype=torch.long, device=device)
        self.toks[:s] = prompt[0]
        self.toks[s] = first[0]
        zero = torch.zeros((), dtype=torch.long, device=device)
        self.n_emitted = zero + 1
        self.rounds, self.proposed, self.accepted = (zero.clone(),
                                                     zero.clone(),
                                                     zero.clone())
        self.done = (first[0] == eos_token_id if eos_token_id is not None
                     else torch.zeros((), dtype=torch.bool, device=device))

    def carried(self):
        return [self.toks, self.n_emitted, self.rounds, self.proposed,
                self.accepted, self.done]


def _device_round(target: CausalLM, draft: CausalLM, t_cache: DenseCache,
                  d_cache: DenseCache, st: _RoundState, s_prompt: int,
                  gamma: int, max_new_tokens: int,
                  eos_token_id: Optional[int]) -> None:
    """One fixed-width round of the device loop, in place on ``st`` and
    the caches (the body a CUDA graph captures). A round after the end
    (done, or the budget emitted) writes the buffer back unchanged and
    advances no counter; its cache writes land at or past the fill."""
    g, width = gamma, gamma + 1
    device = st.toks.device
    iota = torch.arange(width, device=device)
    active = (~st.done) & (st.n_emitted < max_new_tokens)
    t_fill = s_prompt + st.n_emitted - 1         # rows FED to the target
    # 1. draft resync: rewrite the last `width` rows before t_fill from
    #    the buffer (any round advances <= width rows, so the window
    #    covers whatever a previous round left stale; near the start it
    #    clamps to 0 and its columns past the fill are invisible)
    start = (t_fill - width).clamp_min(0)
    chunk = st.toks.index_select(0, start + iota)[None]
    _extend(draft, d_cache, chunk, start, cache_only=True)
    # 2. propose, 3. verify
    last_tok = st.toks.index_select(0, t_fill.reshape(1))
    drafts = _draft_propose(draft, d_cache, last_tok, t_fill, g)
    vchunk = torch.cat([last_tok[:, None], drafts], dim=1)
    logits = _extend(target, t_cache, vchunk, t_fill)
    preds = torch.argmax(logits[0], dim=-1)      # [g+1]
    # 4. the shared rule, then a masked fixed-width write of the window
    a = greedy_accept_len(drafts[0], preds[:-1])
    window = emit_window(drafts[0], preds.gather(0, a.reshape(1))[0], a)
    idx = (s_prompt + st.n_emitted + iota).clamp_max(st.toks.shape[0] - 1)
    st.toks.index_put_((idx,), torch.where(active, window,
                                           st.toks.index_select(0, idx)))
    if eos_token_id is not None:
        hit = ((window == eos_token_id) & (iota <= a)).any()
        st.done.copy_(st.done | (active & hit))
    # stats use the host loop's budget-capped definitions: a short final
    # round proposes only min(gamma, budget) there
    g_eff = (max_new_tokens - st.n_emitted).clamp_max(g)
    zero = torch.zeros_like(a)
    st.proposed.add_(torch.where(active, g_eff, zero))
    st.accepted.add_(torch.where(active, torch.minimum(a, g_eff), zero))
    st.rounds.add_(active.long())
    # 5. rollback = the fill is n_emitted (stale rows are invisible)
    st.n_emitted.add_(torch.where(active, a + 1, zero))


def _device_loop(target, draft, t_cache, d_cache, prompt, first, gamma,
                 max_new_tokens, eos_token_id):
    """Rounds until the budget is emitted or eos: replayed as one CUDA
    graph on the card, eager on the CPU; the host reads ``(n_emitted,
    done)`` every :data:`CHECK_EVERY` rounds. Returns ``(tokens,
    n_emitted, rounds, proposed, accepted)`` on the host."""
    s_prompt = prompt.shape[1]
    st = _RoundState(prompt, first, s_prompt + max_new_tokens + gamma + 1,
                     eos_token_id)

    def body():
        _device_round(target, draft, t_cache, d_cache, st, s_prompt, gamma,
                      max_new_tokens, eos_token_id)

    device = prompt.device
    run = body
    if device.type == "cuda":
        from pyspark_tf_gke_tpu_torch.ops import graphs

        run = graphs.capture(body, st.carried(), device).replay
    flags = torch.empty(2, dtype=torch.long,
                        pin_memory=device.type == "cuda")
    while True:
        for _ in range(CHECK_EVERY):
            run()
        flags.copy_(torch.stack([st.n_emitted, st.done.long()]),
                    non_blocking=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        if flags[1] or flags[0] >= max_new_tokens:
            break
    return (st.toks.cpu().tolist(), int(st.n_emitted), int(st.rounds),
            int(st.proposed), int(st.accepted))


@torch.no_grad()
def speculative_generate(target_model: CausalLM, draft_model: CausalLM,
                         prompt_ids, max_new_tokens: int, gamma: int = 4,
                         eos_token_id: Optional[int] = None,
                         return_stats: bool = False,
                         device_loop: Optional[bool] = None):
    """Greedy generation from the TARGET model, accelerated by a draft.

    Returns ``[1, S_prompt + max_new_tokens]`` on the host — the tokens
    of ``generate(target_model, prompt_ids, ...)`` greedy (after eos,
    positions pad with eos). With ``return_stats`` also returns
    ``{"rounds", "proposed", "accepted", "tokens_per_round"}``.

    ``device_loop``: ``True`` the device loop, ``False`` the host loop,
    ``None`` (default) the device loop whenever its stricter bound fits —
    its verify chunk may overhang the final token by up to ``gamma``,
    so it needs ``s_prompt + max_new_tokens + gamma - 1 <= max_seq_len``
    on both models (the host loop shrinks its last chunks instead)."""
    if not isinstance(prompt_ids, torch.Tensor):
        prompt_ids = torch.from_numpy(np.asarray(prompt_ids))
    if prompt_ids.shape[0] != 1:
        raise ValueError(
            f"speculative decoding is batch-1 (latency tool; the scalar "
            f"cache fill index cannot roll rows back independently), "
            f"got batch {prompt_ids.shape[0]}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    tcfg, dcfg = target_model.cfg, draft_model.cfg
    if tcfg.vocab_size != dcfg.vocab_size:
        raise ValueError(
            f"draft vocab {dcfg.vocab_size} != target vocab "
            f"{tcfg.vocab_size}: the models must share a tokenizer")
    if draft_model.device != target_model.device:
        raise ValueError(f"draft on {draft_model.device}, target on "
                         f"{target_model.device}: one device for both")
    s_prompt = prompt_ids.shape[1]
    if s_prompt + max_new_tokens > tcfg.max_seq_len:
        raise ValueError(
            f"prompt {s_prompt} + {max_new_tokens} new tokens exceeds the "
            f"target's max_seq_len {tcfg.max_seq_len}")
    if s_prompt + max_new_tokens > dcfg.max_seq_len:
        raise ValueError(
            f"prompt {s_prompt} + {max_new_tokens} new tokens exceeds the "
            f"DRAFT's max_seq_len {dcfg.max_seq_len}")
    device_fits = (s_prompt + max_new_tokens + gamma - 1 <= tcfg.max_seq_len
                   and s_prompt + max_new_tokens + gamma - 1
                   <= dcfg.max_seq_len)
    if device_loop is None:
        device_loop = device_fits
    elif device_loop and not device_fits:
        raise ValueError(
            f"device_loop needs prompt {s_prompt} + {max_new_tokens} new "
            f"+ gamma {gamma} - 1 within both models' max_seq_len "
            f"(target {tcfg.max_seq_len}, draft {dcfg.max_seq_len}); use "
            f"device_loop=None/False")

    device = target_model.device
    prompt = prompt_ids.to(device=device, dtype=torch.long)
    # prefill both models; the target's last-token logits give the first
    # emitted token for free
    t_cache, t_last = _prefill(target_model, prompt)
    d_cache, _ = _prefill(draft_model, prompt)
    first = torch.argmax(t_last, dim=-1)

    if device_loop:
        buf, n_emitted, rounds, proposed, accepted_total = _device_loop(
            target_model, draft_model, t_cache, d_cache, prompt, first,
            gamma, max_new_tokens, eos_token_id)
        emitted = buf[s_prompt:s_prompt + min(n_emitted, max_new_tokens)]
    else:
        emitted = [int(first[0])]
        # fill levels: rows written so far (the newest emitted token is
        # fed next round)
        t_fill = d_fill = s_prompt
        rounds = proposed = accepted_total = 0
        while len(emitted) < max_new_tokens and (
                eos_token_id is None or eos_token_id not in emitted):
            rounds += 1
            g = min(gamma, max_new_tokens - len(emitted))
            # 1. the draft syncs on the emitted tokens it has not cached
            #    (all but the newest, which the propose feeds)
            pending = emitted[d_fill - s_prompt:len(emitted) - 1]
            if pending:
                _extend(draft_model, d_cache,
                        torch.tensor([pending], device=device), d_fill,
                        cache_only=True)
                d_fill += len(pending)
            last_tok = torch.tensor([emitted[-1]], device=device)
            drafts = _draft_propose(draft_model, d_cache, last_tok, d_fill, g)
            d_fill += g  # holds last_tok .. d_{g-2} (d_{g-1} never fed)
            drafts_host = drafts[0].tolist()
            proposed += g
            # 2. the target verifies [last_tok, d_0..d_{g-1}] in one
            #    chunk forward
            logits = _extend(target_model, t_cache,
                             torch.cat([last_tok[:, None], drafts], dim=1),
                             t_fill)
            t_fill += g + 1
            preds = torch.argmax(logits[0], dim=-1)
            # 3. greedy acceptance (the shared rule)
            a = int(greedy_accept_len(drafts[0], preds[:g]))
            preds_host = preds.tolist()
            accepted_total += a
            emitted.extend(drafts_host[:a])
            if len(emitted) < max_new_tokens:
                emitted.append(preds_host[a])
            # 4. rollback both caches to the verified prefix: the rows
            #    FED so far (all emitted tokens but the newest)
            t_fill = s_prompt + len(emitted) - 1
            d_fill = min(d_fill, t_fill)
        n_emitted = len(emitted)
    out = _pad_after_eos([int(t) for t in emitted[:max_new_tokens]],
                         max_new_tokens, eos_token_id)
    result = torch.cat([prompt_ids.long().cpu(),
                        torch.tensor([out], dtype=torch.long)], dim=1)
    if return_stats:
        # the first token came free from the prefill, not from a round;
        # the cap keeps the final round's overshoot out of the stat
        return result, {"rounds": rounds, "proposed": proposed,
                        "accepted": accepted_total,
                        "tokens_per_round":
                        (min(n_emitted, max_new_tokens) - 1)
                        / max(rounds, 1)}
    return result
