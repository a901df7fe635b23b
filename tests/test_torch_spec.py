"""PyTorch port, speculative decoding: the acceptance rule, the standalone
driver, the trained fixture and the server's ``--spec-tokens`` /
``--draft-bundle`` (the slot engine's spec chunks are in
``tests/test_torch_spec_engine.py``).

The JAX package is the oracle, in f32 on the CPU at the widths of its
own spec tests (``tests/test_spec_engine.py``: vocab 97, hidden 32, 2
layers, 4 heads over 2 KV heads; a 1-layer hidden-16 draft), weights
carried across with ``params_from_flax``: the greedy helpers, and the
port's host and device loops against the JAX ``speculative_generate``
(tokens and stats exactly: an unrelated draft, a self-draft, eos
padding, GQA with an int8 KV cache) and against the port's
``generate``; the fixture's text and rows bit for bit. The sampled
rule (counter-based noise, not threefry) is tested by distribution.
Over HTTP, ``--spec-tokens 3 --draft-bundle`` completes as
``--spec-tokens 0`` does.
"""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import speculative as jspec
from pyspark_tf_gke_tpu.models.causal_lm import CausalLM as JaxLM
from pyspark_tf_gke_tpu.models.causal_lm import CausalLMConfig as JaxConfig
from pyspark_tf_gke_tpu.train import spec_fixture as jfix
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models import lanes
from pyspark_tf_gke_tpu_torch.models import speculative as tspec
from pyspark_tf_gke_tpu_torch.models.causal_lm import _filter_logits
from pyspark_tf_gke_tpu_torch.train import spec_fixture as tfix
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   export_serving_bundle,
                                                   params_from_flax)

torch.set_num_threads(1)

K = 3  # the spec width of most engine cases
V = 97
TARGET = dict(vocab_size=V, hidden_size=32, num_layers=2, num_heads=4,
              num_kv_heads=2, intermediate_size=64, max_seq_len=256)
DRAFT = dict(vocab_size=V, hidden_size=16, num_layers=1, num_heads=2,
             num_kv_heads=2, intermediate_size=32, max_seq_len=256)
PAGED = dict(kv_page_size=16, kv_num_pages=64)


def _port(cfg, params):
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    model = tlm.CausalLM(config_from_dict(fields))
    return model.load_params(params_from_flax(params)).eval()


def _pair(fields, seed):
    """``(jax dense, jax paged, params, port dense, port paged)``."""
    cfg = JaxConfig(**fields, dtype=jnp.float32)
    jm = JaxLM(cfg)
    params = jax.device_get(nn.meta.unbox(jm.init(
        jax.random.key(seed), jnp.ones((1, 8), jnp.int32))["params"]))
    pcfg = dataclasses.replace(cfg, **PAGED)
    return jm, JaxLM(pcfg), params, _port(cfg, params), _port(pcfg, params)


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET, 0)


@pytest.fixture(scope="module")
def draft():
    jm, _, params, tm, _ = _pair(DRAFT, 7)
    return jm, params, tm


def _prompt(rng, n):
    return rng.integers(1, V, n).astype(np.int32)


# -- the acceptance rule ----------------------------------------------------------


def test_greedy_rule_matches_jax():
    rng = np.random.default_rng(3)
    b, k = 64, 4
    picks = rng.integers(0, 5, (b, k))
    drafts = np.where(rng.random((b, k)) < 0.7, picks, rng.integers(0, 5, (b, k)))
    corr = rng.integers(0, V, b)
    ja = np.asarray(jspec.greedy_accept_len(jnp.asarray(drafts),
                                            jnp.asarray(picks)))
    ta = tspec.greedy_accept_len(torch.as_tensor(drafts),
                                 torch.as_tensor(picks))
    assert ta.tolist() == ja.tolist() and 0 < ja.mean() < k
    jw = jspec.emit_window(jnp.asarray(drafts), jnp.asarray(corr),
                           jnp.asarray(ja))
    tw = tspec.emit_window(torch.as_tensor(drafts), torch.as_tensor(corr), ta)
    assert tw.tolist() == np.asarray(jw).tolist()
    # greedy accept_and_correct on logits, perfect and random drafts
    tgt = rng.normal(size=(b, k + 1, V)).astype(np.float32)
    dlog = rng.normal(size=(b, k, V)).astype(np.float32)
    best = tgt.argmax(-1)[:, :k]
    mixed = np.where(rng.random((b, k)) < 0.8, best,
                     rng.integers(0, V, (b, k)))
    for d in (best, mixed):
        ja, jc = jspec.accept_and_correct(jnp.asarray(d), jnp.asarray(dlog),
                                          jnp.asarray(tgt))
        ta, tc = tspec.accept_and_correct(torch.as_tensor(d),
                                          torch.as_tensor(dlog),
                                          torch.as_tensor(tgt))
        assert ta.tolist() == np.asarray(ja).tolist()
        assert tc.tolist() == np.asarray(jc).tolist()
    assert ta.tolist() != [k] * b  # the mixed drafts do get rejected


def _lanes(n):
    keys = torch.tensor([lanes.seed_key(i) for i in range(n)])
    return keys, torch.zeros(n, dtype=torch.long)


def _filtered(logits, temp, top_p):
    """The temperature- and top-p-filtered distribution of ``[..., V]``."""
    scaled = torch.as_tensor(logits) / temp
    return torch.softmax(_filter_logits(scaled, None, top_p), dim=-1)


@pytest.mark.parametrize("temp,top_p", [(1.0, 1.0), (0.7, 0.9)],
                         ids=["t1", "t07_p09"])
def test_sampled_rule_samples_the_filtered_target(temp, top_p):
    """Fixed p and q over V = 11, drafts drawn from the filtered q on
    20000 lanes: the first emitted token (d_1 when accepted, else the
    correction) follows the filtered p_0 within a total variation
    distance of 0.03 (the sampling noise of 20000 draws is ~0.01)."""
    n, k, v = 20000, 3, 11
    rng = np.random.default_rng(5)
    p_log = rng.normal(scale=1.5, size=(k + 1, v)).astype(np.float32)
    q_log = (p_log[:k] + rng.normal(scale=1.0, size=(k, v))).astype(
        np.float32)
    q = _filtered(q_log, temp, top_p).numpy().astype(np.float64)
    drafts = np.stack([rng.choice(v, size=n, p=q[i] / q[i].sum())
                       for i in range(k)], axis=1)
    keys, draws = _lanes(n)
    a, corr = tspec.accept_and_correct(
        torch.as_tensor(drafts), torch.as_tensor(q_log).expand(n, k, v),
        torch.as_tensor(p_log).expand(n, k + 1, v),
        temps=torch.full((n,), temp), topps=torch.full((n,), top_p),
        keys=keys, draws=draws)
    first = torch.where(a > 0, torch.as_tensor(drafts[:, 0]), corr).numpy()
    hist = np.bincount(first, minlength=v) / n
    want = _filtered(p_log[0], temp, top_p).numpy()
    tv = 0.5 * np.abs(hist - want).sum()
    assert tv < 0.03, (tv, hist, want)
    assert 0 < float(a.float().mean()) < k  # both branches ran


def test_sampled_rule_accepts_when_p_equals_q_and_rejects_negligible_mass():
    n, k = 512, 3
    rng = np.random.default_rng(7)
    p_log = torch.as_tensor(rng.normal(size=(n, k + 1, V)).astype(np.float32))
    keys, draws = _lanes(n)
    temps, topps = torch.full((n,), 0.7), torch.ones(n)
    drafts = torch.as_tensor(rng.integers(0, V, (n, k)))
    # p == q: u * q(d) < p(d) = q(d) for every u in (0, 1)
    a, corr = tspec.accept_and_correct(drafts, p_log[:, :k], p_log,
                                       temps=temps, topps=topps, keys=keys,
                                       draws=draws)
    assert a.tolist() == [k] * n
    assert bool(((corr >= 0) & (corr < V)).all())
    # a draft the target scores 40 below its best at T = 0.7: its mass is
    # at most exp(-40 / 0.7) ~ 1.6e-25, while the smallest u * q(d) is
    # 2**-25 * ~1 ~ 3e-8: rejected on every lane, never the correction
    bad = torch.argmin(p_log[:, 0], dim=-1)
    tgt = p_log.clone()
    tgt[torch.arange(n), 0, bad] = tgt[:, 0].max(dim=-1).values - 40.0
    d = drafts.clone()
    d[:, 0] = bad
    q_log = torch.full((n, k, V), -20.0)
    q_log[torch.arange(n), 0, bad] = 20.0
    mass = _filtered(tgt[:, 0], 0.7, 1.0)[torch.arange(n), bad]
    assert float(mass.max()) < 1e-24
    a, corr = tspec.accept_and_correct(d, q_log, tgt, temps=temps,
                                       topps=topps, keys=keys, draws=draws)
    assert a.tolist() == [0] * n
    assert not bool((corr == bad).any())


# -- the standalone driver ----------------------------------------------------------


@pytest.fixture(scope="module")
def gqa_int8():
    jm, _, params, tm, _ = _pair(dict(TARGET, num_kv_heads=1), 3)
    cfg = dataclasses.replace(jm.cfg, kv_cache_quant=True)
    return JaxLM(cfg), params, _port(cfg, params)


SPEC_CASES = {  # name -> (draft kind, prompt length, max_new, gamma, eos)
    "unrelated_draft": ("draft", 9, 12, 3, False),
    "self_draft": ("self", 9, 12, 3, False),
    "eos_padding": ("draft", 7, 14, 4, True),
    "gqa_int8_kv": ("gqa_int8", 5, 12, 3, False),
}


_JAX_SPEC = {}  # case -> the JAX driver's (tokens, stats): one per case


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_speculative_generate_matches_jax(target, draft, gqa_int8, case,
                                          loop):
    """The port's host and device loops against the JAX driver (its host
    loop; the JAX tests hold its device loop to it)."""
    kind, n, max_new, gamma, use_eos = SPEC_CASES[case]
    jt, _, tparams, tt, _ = target
    jd, dparams, td = draft
    if kind == "self":
        jd, dparams, td = jt, tparams, tt
    if kind == "gqa_int8":
        jt, tparams, tt = gqa_int8
    prompt = _prompt(np.random.default_rng(11), n)[None]
    eos = None
    if use_eos:
        plain = tlm.generate(tt, prompt, max_new)
        eos = int(plain[0, n + 4])
    if case not in _JAX_SPEC:
        out, stats = jspec.speculative_generate(
            jt, tparams, jd, dparams, jnp.asarray(prompt), max_new,
            gamma=gamma, eos_token_id=eos, return_stats=True,
            device_loop=False)
        _JAX_SPEC[case] = (np.asarray(out).tolist(), stats)
    want, jstats = _JAX_SPEC[case]
    got, stats = tspec.speculative_generate(
        tt, td, prompt, max_new, gamma=gamma, eos_token_id=eos,
        return_stats=True, device_loop=loop == "device")
    assert got.tolist() == want
    assert stats == jstats
    assert got.tolist() == tlm.generate(tt, prompt, max_new,
                                        eos_token_id=eos).tolist()
    if kind == "self":
        assert stats["accepted"] == stats["proposed"] > 0
    if use_eos:
        tail = got[0, n:].tolist()
        assert eos in tail and tail[-1] == eos


def test_speculative_generate_validations(target, draft):
    _, _, _, tt, _ = target
    _, _, td = draft
    prompt = np.zeros((1, 4), np.int32)
    cases = [
        (dict(prompt_ids=np.zeros((2, 4), np.int32), max_new_tokens=4),
         "batch-1"),
        (dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
        (dict(max_new_tokens=4, gamma=0), "gamma must be >= 1"),
        (dict(max_new_tokens=500), "exceeds the target's max_seq_len"),
        (dict(max_new_tokens=252, device_loop=True),
         "device_loop needs prompt 4"),
    ]
    for kw, msg in cases:
        kw = dict(dict(prompt_ids=prompt), **kw)
        with pytest.raises(ValueError, match=msg):
            tspec.speculative_generate(tt, td, **kw)
    short = tlm.CausalLM(dataclasses.replace(td.cfg, max_seq_len=64))
    with pytest.raises(ValueError, match="DRAFT's max_seq_len 64"):
        tspec.speculative_generate(tt, short, prompt, 100)
    other = tlm.CausalLM(dataclasses.replace(td.cfg, vocab_size=50))
    with pytest.raises(ValueError, match="draft vocab 50 != target vocab"):
        tspec.speculative_generate(tt, other, prompt, 4)
    # the bound that does not fit the device loop picks the host loop
    out, stats = tspec.speculative_generate(tt, td, prompt, 252,
                                            return_stats=True)
    assert out.shape == (1, 256) and stats["rounds"] > 0


# -- the trained fixture ------------------------------------------------------------


def test_fixture_rows_match_jax():
    for seed, skew in ((0, 0.75), (5, 0.8), (3, 0.6)):
        assert (tfix.synthetic_text(500, seed=seed, skew=skew)
                == jfix.synthetic_text(500, seed=seed, skew=skew))
        for seq, rows in ((64, 32), (16, 8), (8, 16)):
            np.testing.assert_array_equal(
                tfix._pack_rows(seq, rows, seed=seed, skew=skew),
                jfix._pack_rows(seq, rows, seed=seed, skew=skew))


def test_port_training_loop_learns_the_chain():
    """The port's own ``_train_lm`` (and ``make_spec_fixture``) on the CPU
    at a few steps: the loss on the training rows falls."""
    rows = tfix._pack_rows(32, 4, seed=0)
    cfg = tlm.CausalLMConfig(vocab_size=259, hidden_size=32, num_layers=1,
                             num_heads=2, intermediate_size=64,
                             max_seq_len=64, dtype=torch.float32)
    model = tlm.CausalLM(cfg, param_dtype=torch.float32)
    model.load_params(tlm.init_params(cfg, seed=0))
    ids = torch.as_tensor(rows, dtype=torch.long)

    def loss():
        with torch.no_grad():
            logits = model(ids)[:, :-1]
            return float(torch.nn.functional.cross_entropy(
                logits.reshape(-1, 259), ids[:, 1:].reshape(-1)))

    before = loss()
    tfix._train_lm(model, rows, steps=40, lr=3e-3)
    assert loss() < 0.6 * before
    t, d, prompt = tfix.make_spec_fixture(steps=2, device="cpu")
    assert (t.cfg.hidden_size, d.cfg.hidden_size, prompt.shape) == (
        64, 32, (1, 16))


# -- the server ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_bundles(tmp_path_factory):
    """A paged byte-tokenizer target bundle, a smaller draft bundle and a
    draft bundle of another vocabulary (port bundles, random weights)."""
    root = tmp_path_factory.mktemp("spec_bundles")
    common = dict(intermediate_size=64, max_seq_len=128, dtype=torch.float32)
    tcfg = tlm.CausalLMConfig(vocab_size=259, hidden_size=32, num_layers=2,
                              num_heads=4, kv_page_size=16, kv_num_pages=32,
                              **common)
    dcfg = tlm.CausalLMConfig(vocab_size=259, hidden_size=16, num_layers=1,
                              num_heads=2, **common)
    bad = dataclasses.replace(dcfg, vocab_size=300)
    out = {}
    for name, cfg, seed in (("target", tcfg, 1), ("draft", dcfg, 2),
                            ("bad", bad, 3)):
        out[name] = export_serving_bundle(cfg, tlm.init_params(cfg, seed),
                                          str(root / name))
    return out


def _serve(server):
    from pyspark_tf_gke_tpu_torch.train.serve import start_http_server

    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_server_spec_tokens_and_draft_bundle(spec_bundles):
    from pyspark_tf_gke_tpu_torch.train.serve import BundleServer

    prompts = ["speculative decoding", "the tpu runs", "abc"]
    outs = {}
    for name, kw in (("plain", dict(spec_tokens=0)),
                     ("spec", dict(spec_tokens=3,
                                   draft_bundle_dir=spec_bundles["draft"]))):
        server = BundleServer(spec_bundles["target"], device="cpu",
                              continuous_slots=2, continuous_chunk=4, **kw)
        httpd, thread, url = _serve(server)
        try:
            outs[name] = _post(url, "/v1/generate",
                               {"prompts": prompts, "max_new_tokens": 10})
            health = _post(url, "/healthz")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.shutdown()
            thread.join(10)
        if name == "spec":
            spec = health["continuous"]["spec"]
            assert spec["spec_tokens"] == 3 and not spec["self_draft"]
            assert spec["proposed"] > 0
            assert set(spec) == {"spec_tokens", "rounds", "proposed",
                                 "accepted", "accept_rate",
                                 "recent_accept_rate", "self_draft"}
            assert health["speculative_draft"] == spec_bundles["draft"]
        else:
            assert "spec" not in health["continuous"]
            assert health["speculative_draft"] is None
    strip = [{k: c[k] for k in ("prompt", "completion", "new_tokens")}
             for c in outs["plain"]["completions"]]
    assert strip == [{k: c[k] for k in ("prompt", "completion", "new_tokens")}
                     for c in outs["spec"]["completions"]]


def test_server_draft_bundle_alone_and_refusals(spec_bundles):
    from pyspark_tf_gke_tpu_torch.train.serve import BundleServer, SPEC_GAMMA

    plain = BundleServer(spec_bundles["target"], device="cpu")
    server = BundleServer(spec_bundles["target"], device="cpu",
                          draft_bundle_dir=spec_bundles["draft"])
    want = plain.generate(["hello there"], max_new_tokens=12)[0]
    got = server.generate(["hello there"], max_new_tokens=12)[0]
    assert got["completion"] == want["completion"]
    assert got["speculative"]["gamma"] == SPEC_GAMMA == 4
    assert 0 <= got["speculative"]["acceptance_rate"] <= 1
    assert got["speculative"]["tokens_per_round"] >= 1
    # two prompts, or sampling, take the plain path
    assert "speculative" not in server.generate(["a", "b"], 4)[0]
    assert "speculative" not in server.generate(["a"], 4, temperature=0.7,
                                                seed=1)[0]
    assert server.health()["speculative_draft"] == spec_bundles["draft"]
    with pytest.raises(ValueError, match="--spec-tokens requires "
                                         "--continuous-slots"):
        BundleServer(spec_bundles["target"], device="cpu", spec_tokens=2)
    with pytest.raises(ValueError, match="draft bundle vocab 300 != target "
                                         "vocab 259"):
        BundleServer(spec_bundles["target"], device="cpu",
                     draft_bundle_dir=spec_bundles["bad"])
    from pyspark_tf_gke_tpu_torch.train.serve import parse_args

    args = parse_args(["--bundle", "b", "--spec-tokens", "3",
                       "--draft-bundle", "d"])
    assert (args.spec_tokens, args.draft_bundle) == (3, "d")
