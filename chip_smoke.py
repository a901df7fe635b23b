#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pyspark_tf_gke_tpu_torch``) on one card.

``python3 chip_smoke.py`` from the root of a checkout:

1. reports the card (``nvidia-smi`` name and power limit, torch/CUDA
   versions, compute capability; 9.0 is required);
2. builds the hand-written kernels from ``pyspark_tf_gke_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes, in bf16 and f32, and times kernel, plain
   version and a library yardstick with CUDA events;
4. serves a full-width GPT-small paged bundle (random weights from a
   numpy seed, int8 export) through ``BundleServer`` + the HTTP server
   with 8 continuous slots: 12 ``/v1/generate`` requests from 3 client
   threads (greedy and seeded top-p) and one ``/v1/score``; every
   kernel's launch counter must move during this phase; then profiles
   one batched prefill admission and two decode chunks of the engine
   (host wall time against device-busy time, top kernels);
5. checks parity on the card: the engine's f32 greedy tokens equal the
   dense ``generate``'s, and full-width bf16 prefill logits through the
   kernels agree with the plain versions;
6. prints one ``{"kernels": [...]}`` line, then
7. ``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT_PKG = ROOT / "pyspark_tf_gke_tpu_torch"

# H100 SXM data-sheet peaks (dense) — the bound is the larger of bytes
# over memory rate and operations over the peak for the inputs' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances of kernel vs plain version on the same inputs. f32: both
# sides compute in f32 and differ by summation order and exp/rsqrt
# rounding (a few ulps of O(1) values). bf16: the kernels keep scores,
# probabilities and accumulators in f32 and round once at the output,
# while the plain versions round the probabilities (and dequantized
# pages) to bf16 before the P.V product — allow 2 bf16 ulps relative.
# Attention outputs average many values and can be small (|out| ~ 0.05
# in late rows), so bf16 also requires the relative L2 error of the
# whole tensor to stay under 1e-2 (a few bf16 roundings of ~2e-3 each);
# a fault confined to the bf16 instantiation moves that by far more.
TOL = {"float32": dict(atol=5e-5, rtol=1e-5, rel_l2=None),
       "bfloat16": dict(atol=2e-2, rtol=1.6e-2, rel_l2=1e-2)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, warmup: int = 3, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean per-call time of ``iters``
    back-to-back calls, from CUDA events (after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(out, ref, dtype_name: str, what: str) -> float:
    import torch

    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    tol = TOL[dtype_name]
    ok = bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
    max_err = float(err.max()) if err.numel() else 0.0
    rel = float(err.norm() / ref.norm().clamp_min(1e-30))
    if tol["rel_l2"] is not None:
        ok = ok and rel <= tol["rel_l2"]
    log(f"  {what}: max_abs_err {max_err:.3e} (tolerance atol "
        f"{tol['atol']:g} + rtol {tol['rtol']:g}*|ref|), relative L2 "
        f"{rel:.2e} (tolerance {tol['rel_l2']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{what}: kernel disagrees with its plain version")
    return max_err


# -- phase 3: kernels against their plain versions ----------------------------


def check_layernorm(torch, dev):
    import torch.nn.functional as F

    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for rows in (8 * 1024, 8):
            x = (torch.randn(rows, 768, generator=g, device=dev) * 2 + 0.5
                 ).to(dtype)
            r = torch.randn(rows, 768, generator=g, device=dev).to(dtype)
            scale = torch.randn(768, generator=g, device=dev)
            bias = torch.randn(768, generator=g, device=dev)
            for res in (None, r):
                tag = (f"layernorm {name} [{rows},768]"
                       f"{' +residual' if res is not None else ''}")
                err = compare(ln.fused_layernorm(x, scale, bias, 1e-5, res),
                              ln.layernorm_plain(x, scale, bias, 1e-5, res),
                              name, tag)
                if dtype == torch.bfloat16 and rows == 8192 and res is None:
                    ms = cuda_ms(lambda: ln.fused_layernorm(x, scale, bias,
                                                            1e-5))
                    plain = cuda_ms(lambda: ln.layernorm_plain(x, scale, bias,
                                                               1e-5))
                    w, b = scale.to(dtype), bias.to(dtype)
                    lib = cuda_ms(lambda: F.layer_norm(x, (768,), w, b, 1e-5))
                    nbytes = 2 * x.numel() * x.element_size() + 2 * 768 * 4
                    bms, by = bound(nbytes, 8 * x.numel(), "float32")
                    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bms, bound_by=by, library_ms=lib,
                               shape="[8192,768] bf16")
    return rec


def check_flash(torch, dev):
    import torch.nn.functional as F

    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s in (128, 1024):
            q, k, v = (torch.randn(8, s, 12, 64, generator=g, device=dev
                                   ).to(dtype) for _ in range(3))
            out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
            ref, _ = fa.flash_attention_plain(q, k, v, causal=True)
            err = compare(out, ref, name,
                          f"flash causal {name} B=8 S={s} H=12 D=64")
            if dtype == torch.bfloat16 and s == 1024:
                ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
                plain = cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=True))
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
                nbytes = 4 * q.numel() * q.element_size() + 8 * 12 * s * 4
                ops = 4 * 8 * 12 * 64 * (s * (s + 1) / 2)
                bms, by = bound(nbytes, ops, name)
                rec = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           shape="B=8 S=1024 H=12 D=64 causal bf16")
        # key padding + segments, with one fully masked row, and the lse
        q, k, v = (torch.randn(2, 256, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        kv_mask = torch.rand(2, 256, generator=g, device=dev) > 0.2
        kv_mask[1] = False  # batch row 1: no key at all
        segs = (torch.arange(256, device=dev) // 48).to(torch.int32)
        segs = segs[None].repeat(2, 1).contiguous()
        out, lse = fa.flash_attention_fwd(q, k, v, kv_mask=kv_mask,
                                          causal=True, segment_ids=segs)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask=kv_mask,
                                                causal=True, segment_ids=segs)
        compare(out, ref, name, f"flash kv_mask+segments {name} B=2 S=256")
        check(bool((out[1] == 0).all()), "fully masked row is not zero")
        check(bool(torch.isposinf(lse[1]).all()),
              "fully masked row lse is not +inf")
        finite = torch.isfinite(ref_lse)
        check(bool((torch.isfinite(lse) == finite).all()),
              "lse masked rows disagree")
        compare(lse[finite], ref_lse[finite], "float32",
                f"flash lse {name}")
    return rec


def _paged_case(torch, dev, g, dtype, hkv, s, quant):
    n, p, h, d, mp = 128, 64, 12, 64, 16
    fills = torch.tensor([0, 1, 63, 64, 65, 500, 960, 1024],
                         dtype=torch.int32, device=dev)
    b = fills.numel()
    table = torch.full((b, mp), n, dtype=torch.int32)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(2))
    used = 0
    for row, fill in enumerate(fills.tolist()):
        live = -(-fill // p)
        table[row, :live] = perm[used:used + live]
        used += live
    table[5, 3] = n  # a sentinel inside a live range: clamped, as the
    #                  reference clamps it
    table = table.to(dev)
    if quant:
        kp = torch.randint(-127, 128, (n, p, hkv, d), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n, p, hkv, d), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(n, p, hkv, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(n, p, hkv, generator=g, device=dev) * 0.02 + 1e-3
    else:
        kp, vp = (torch.randn(n, p, hkv, d, generator=g, device=dev
                              ).to(dtype) for _ in range(2))
        ks = vs = None
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, table, fills, ks, vs


def check_paged(torch, dev):
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(3)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for hkv, s, quant in ((12, 1, False), (4, 1, False), (12, 1, True),
                              (4, 8, True), (12, 8, False)):
            q, kp, vp, table, fills, ks, vs = _paged_case(
                torch, dev, g, dtype, hkv, s, quant)
            out = pa.paged_attention_chunk(q, kp, vp, table, fills, ks, vs)
            ref = pa.paged_attention_chunk_plain(q, kp, vp, table, fills,
                                                 ks, vs)
            err = compare(out, ref, name,
                          f"paged {name} slots=8 N=128 P=64 H=12 Hkv={hkv} "
                          f"S={s}{' int8' if quant else ''}")
            check(bool((out[0] == 0).all()), "empty slot is not zero")
            if dtype == torch.bfloat16 and (hkv, s, quant) == (12, 1, False):
                q1 = q[:, 0].contiguous()
                ms = cuda_ms(lambda: pa.paged_attention(q1, kp, vp, table,
                                                        fills))
                plain = cuda_ms(lambda: pa.paged_attention_chunk_plain(
                    q, kp, vp, table, fills))
                lib = cuda_ms(lambda: _sdpa_over_gathered(
                    torch, q, kp, vp, table, fills))
                live = int(fills.sum())
                nbytes = (2 * live * hkv * 64 * kp.element_size()
                          + 2 * q.numel() * q.element_size()
                          + table.numel() * 4 + fills.numel() * 4)
                ops = 4 * live * 12 * 64
                bms, by = bound(nbytes, ops, name)
                rec = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           shape="8 slots, fills {0..1024}, S=1 bf16")
    return rec


def _sdpa_over_gathered(torch, q, kp, vp, table, fills):
    """Library yardstick (never called by the port): gather every table
    page, then ``scaled_dot_product_attention`` with a key mask."""
    import torch.nn.functional as F

    n, p, hkv, d = kp.shape
    b, s, h, _ = q.shape
    safe = table.long().clamp(0, n - 1)
    k = kp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    v = vp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    keep = (torch.arange(k.shape[2], device=q.device)[None, :]
            < fills[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=keep)


# -- phase 4: the main path -----------------------------------------------------


def _prompt(rng: random.Random, n: int) -> str:
    words = ("paged", "attention", "kernel", "hopper", "serving", "token",
             "cache", "slot", "batch", "decode", "prefill", "layer")
    out = ""
    while len(out) < n:
        out += rng.choice(words) + " "
    return out[:n]


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def run_main_path(torch, dev, modules, cfg):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)

    t0 = time.perf_counter()
    bundle = PORT_PKG / "_build" / "chip_smoke_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    server = BundleServer(str(bundle), device=str(dev), continuous_slots=8,
                          continuous_chunk=16)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    log(f"  bundle exported and served in {time.perf_counter() - t0:.1f} s "
        f"({url})")
    try:
        rng = random.Random(0)
        lengths = (20, 100, 300, 700)
        jobs = []
        for i in range(12):
            body = {"prompt": _prompt(rng, lengths[i % 4]),
                    "max_new_tokens": (16, 32, 48, 64)[(i * 7) % 4]}
            if i in (3, 8):
                body.update(temperature=0.8, top_p=0.9, seed=100 + i)
            jobs.append(body)
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2})
        torch.cuda.synchronize()
        for mod in modules.values():  # count only the traffic below
            mod.launches = 0
        results, errors = [None] * len(jobs), []

        def client(idx):
            for j in range(idx, len(jobs), 3):
                try:
                    results[j] = _post(url + "/v1/generate", jobs[j])
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(f"request {j}: {exc}")

        t_start = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(900)
        wall = time.perf_counter() - t_start
        check(not errors, "; ".join(errors))
        texts = [_prompt(rng, n) for n in (40, 200, 600, 1000)]
        score = _post(url + "/v1/score", {"texts": texts})
        torch.cuda.synchronize()
        launches = {name: mod.launches for name, mod in modules.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
    new_tokens = 0
    for body, res in zip(jobs, results):
        check(res is not None and res[0] == 200, f"generate failed: {res}")
        comps = res[1]["completions"]
        check(len(comps) == 1 and comps[0]["prompt"] == body["prompt"]
              and comps[0]["completion"].startswith(body["prompt"])
              and 0 <= comps[0]["new_tokens"] <= body["max_new_tokens"]
              and comps[0]["latency_ms"] > 0, f"malformed completion {comps}")
        new_tokens += comps[0]["new_tokens"]
        log(f"  generate prompt={len(body['prompt'])}B "
            f"max_new={body['max_new_tokens']} "
            f"{'sampled' if 'seed' in body else 'greedy '} -> "
            f"{comps[0]['new_tokens']} tokens, latency_ms "
            f"{comps[0]['latency_ms']}")
    check(score[0] == 200 and len(score[1]["scores"]) == 4,
          f"score failed: {score}")
    for text, sc in zip(texts, score[1]["scores"]):
        check(math.isfinite(sc["nll"]) and sc["nll"] > 0
              and sc["tokens"] == min(len(text), cfg.max_seq_len) - 1,
              f"malformed score {sc}")
    log(f"  score: {[round(s['nll'], 3) for s in score[1]['scores']]}")
    log(f"  aggregate {new_tokens} new tokens in {wall:.3f} s = "
        f"{new_tokens / wall:.1f} tokens/s (12 requests, 3 clients)")
    log(f"  kernel launches on the main path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    shutil.rmtree(bundle, ignore_errors=True)
    return launches, server.model


def _profiled(torch, fn):
    """``(host wall ms, device busy ms, [(kernel, ms), ...])`` of one
    call of ``fn`` under ``torch.profiler`` (busy = the sum of the
    device time of every kernel, copy and set)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        per_kernel.append((ev.key, us / 1e3))
    per_kernel.sort(key=lambda kv: -kv[1])
    return wall, sum(ms for _, ms in per_kernel), per_kernel


def profile_engine(torch, full_model):
    """Where one batched prefill admission and one decode chunk of the
    full-width model spend their time: host wall clock against the
    device-busy total from ``torch.profiler``, and the top kernels."""
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    rng = random.Random(2)
    eng = ContinuousEngine(full_model, num_slots=8, chunk=16)
    for _ in range(8):
        eng.submit([rng.randrange(256) for _ in range(700)],
                   max_new_tokens=300)
    phases = (("prefill admission, 8 x 700-token prompts (bucket 1024)",
               eng._admit_waiting),
              ("decode chunk, 16 steps x 8 live slots", eng.step),
              ("decode chunk again (steady state)", eng.step))
    for what, fn in phases:
        wall, busy, top = _profiled(torch, fn)
        if busy <= 0:
            log(f"  {what}: wall {wall:.2f} ms; device time not visible "
                "to torch.profiler")
            continue
        log(f"  {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
        for name, ms in top[:6]:
            log(f"    {ms:9.3f} ms  {name[:90]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    log(f"  decode chunk without the profiler: wall "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms for 16 steps")


# -- phase 5: parity on the card ------------------------------------------------


def check_parity(torch, dev, full_model, cfg):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine

    with torch.device(dev):
        model = CausalLM(cfg)
    model.load_params(init_params(cfg, seed=1)).eval()
    rng = random.Random(1)
    prompts = [[rng.randrange(256) for _ in range(n)]
               for n in (20, 100, 300, 700, 5, 50)]
    eng = ContinuousEngine(model, num_slots=8, chunk=16)
    rids = {eng.submit(p, max_new_tokens=24): p for p in prompts}
    got = dict(eng.run_until_drained())
    for rid, p in rids.items():
        ref = generate(model, [p], 24)[0, len(p):].tolist()
        check(got[rid] == ref, f"engine tokens {got[rid]} != generate {ref} "
              f"(prompt {len(p)} tokens)")
    log(f"  f32 2-layer engine greedy tokens == dense generate for "
        f"{len(prompts)} prompts (24 tokens each)")

    # a config asking for plain attention must not run it on the card
    with torch.device(dev):
        off = CausalLM(dataclasses.replace(cfg, use_flash=False))
    off.load_state_dict(model.state_dict())
    try:
        with torch.inference_mode():
            off.eval()(torch.tensor([prompts[4]], device=dev))
    except ValueError as exc:
        log(f"  use_flash=False on cuda raises: {exc}")
    else:
        raise SmokeFailure("use_flash=False ran plain attention on the card")

    plain = CausalLM(full_model.cfg, use_kernels=False).to(dev).eval()
    plain.load_state_dict(full_model.state_dict())
    ids = torch.randint(0, full_model.cfg.vocab_size,
                        (2, full_model.cfg.max_seq_len),
                        generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)
    with torch.inference_mode():
        out = full_model(ids)
        ref = plain(ids)
    diff = (out - ref).abs()
    rel = float(diff.norm() / ref.norm())
    max_abs = float(diff.max())
    log(f"  full-width bf16 prefill logits {list(out.shape)}, kernels vs plain: "
        f"max_abs {max_abs:.4f} (tolerance 0.25), relative L2 {rel:.2e} "
        f"(tolerance 2e-2)")
    check(bool(torch.isfinite(out).all()), "non-finite logits")
    check(max_abs <= 0.25 and rel <= 2e-2,
          "bf16 prefill logits through the kernels disagree with plain")


# -- main -----------------------------------------------------------------------


KERNELS = (
    ("layernorm", "pyspark_tf_gke_tpu_torch/csrc/layernorm.cu",
     "pyspark_tf_gke_tpu/ops/pallas/layernorm.py:37"),
    ("flash_attention_fwd", "pyspark_tf_gke_tpu_torch/csrc/flash_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:49"),
    ("paged_attention", "pyspark_tf_gke_tpu_torch/csrc/paged_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/paged_attention.py:124"),
)


def main() -> int:
    if not PORT_PKG.is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"({PORT_PKG} is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: the port runs on a "
              "CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pyspark_tf_gke_tpu_torch.device import resolve_device
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import kernels
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    dev = resolve_device("cuda")  # raises unless capability 9.0
    cap = torch.cuda.get_device_capability(dev)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, capability {cap[0]}.{cap[1]}")

    log("== 2. build")
    t0 = time.perf_counter()
    kernels.library()
    log(f"  kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc wall time {kernels.build_seconds})")

    log("== 3. kernels vs plain versions")
    records = {"layernorm": check_layernorm(torch, dev),
               "flash_attention_fwd": check_flash(torch, dev),
               "paged_attention": check_paged(torch, dev)}
    for name, rec in records.items():
        log(f"  {name} at {rec['shape']}: kernel_ms {rec['ms']:.4f}, "
            f"plain_ms {rec['plain_ms']:.4f}, library_ms "
            f"{rec['library_ms']:.4f}, bound_ms {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")

    modules = {"layernorm": ln, "flash_attention_fwd": fa,
               "paged_attention": pa}
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig

    # GPT-small (CausalLMConfig defaults: vocab 32000, hidden 768, 12
    # layers, 12 heads, FFN 3072, 1024 positions, bf16), paged as the
    # cb bench pages it: 64-token pages, slots x 16 of them
    cfg = CausalLMConfig(kv_page_size=64, kv_num_pages=128)
    log("== 4. main path: BundleServer + HTTP, GPT-small paged, 8 slots")
    launches, full_model = run_main_path(torch, dev, modules, cfg)
    log("== 4b. where the engine's time goes (torch.profiler)")
    profile_engine(torch, full_model)

    log("== 5. parity on the card")
    check_parity(torch, dev, full_model, dataclasses.replace(
        cfg, num_layers=2, dtype=torch.float32))

    out = []
    for name, source, replaces in KERNELS:
        rec = records[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
