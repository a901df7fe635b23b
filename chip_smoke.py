#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pyspark_tf_gke_tpu_torch``) on one card.

``python3 chip_smoke.py`` from the root of a checkout:

1. reports the card (``nvidia-smi`` name and power limit, torch/CUDA
   versions, compute capability; 9.0 is required);
2. builds the hand-written kernels from ``pyspark_tf_gke_tpu_torch/csrc``
   and prints ptxas's registers, shared memory and spills; a tensor-core
   (``wgmma``) kernel that spills fails the run;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes, in bf16 and f32 — the serving kernels (K2f
   also at ragged S = 200 and 77 and on q/k/v views of one [B, S, 3, H,
   D] tensor; K1 at S = 1 and 8 on its decode variant, at fills on its
   split boundaries and at the serving decode shape, and at S = 256 and
   at S = 512 with 12/4 GQA on its chunk variant (bf16) or first design
   (f32), float and int8 pages, queries with no key giving zeros, each
   call on the variant its plan names), the training
   kernels (K2f, K2dq and K2dkv at B=16 S=512 H=12 D=64 and at ragged
   S = 200 and 77: causal, causal + segments, and key padding + segments
   + causal with an empty row and a fully masked batch row, at S = 200
   also on q/k/v views of one [B, S, 3, H, D] tensor with an expanded
   dO; K3 and K3b, with and without the residual, at [8192, 768] and
   [8, 768] and at D = 1024, 1280, 1600, 4096, 100 and 2050, and 1280
   from an unaligned base), and the ResNet
   kernels (K4f, K4dx and K4dw at four of
   ResNet-50's 1x1-conv shapes, a ragged one and one whose K and N are
   not multiples of 8; K5f, K5dx and K5dw at
   the four stride-1 3x3 shapes, a ragged one and one whose K and N are
   not multiples of 8, with and without the transform and the
   statistics); 3b. K2f, K2dq and K2dkv at head widths 128 (bf16 on the
   tensor cores, f32 on the CUDA cores), 32 and 80 (the CUDA cores, 80
   on the 128-wide instantiation) in three mask cases, each call's
   counter moving and ``flash_plan`` naming the expected design, and
   K1's first design at head_dim 128 (decode, the serving decode shape
   and a 256-token piece) — and times kernel, plain version and a
   library yardstick
   with CUDA events (K1 at S = 1 at fills {0..1024}, 716 each and 1024
   each, and at S = 256, against SDPA over the gathered pages; K3 at
   [8192, 768] bf16 with and without the
   residual against F.layer_norm; K3b against
   native_layer_norm_backward; K2f at B=8 S=1024 and B=16 S=512; K2dq and K2dkv at
   B=16 S=512 against the SDPA backward, which computes dQ, dK and dV
   together, on [B, S, H, D] views and on contiguous [B, H, S, D]
   tensors; K4: on all 16 shapes of a ResNet-50 step, summed over its 36
   calls; K5: on the four stage shapes, summed over its 13 calls, against
   cuDNN; K1, K3, K3b, K2f, K2dq, K2dkv, K5f, K5dx, K4f, K4dx and the bf16
   K4dw and K5dw and their yardsticks also replayed from a CUDA graph,
   which takes the host's launch cost out; K2 also at D 128 and D 80
   and K1 at D 128);
4. serving main path: serves a full-width GPT-small paged bundle
   (random weights from a numpy seed, int8 export) through
   ``BundleServer`` + the HTTP server with 8 continuous slots: 12
   ``/v1/generate`` requests from 3 client threads (greedy and seeded
   top-p) and one ``/v1/score``; every serving kernel's launch counter
   must move during this phase, K1's decode variant among them; then
   profiles one batched prefill
   admission and two decode chunks of the engine (host wall time
   against device-busy time, top kernels);
5. checks serving parity on the card: the engine's f32 greedy tokens
   equal the dense ``generate``'s, full-width bf16 prefill logits
   through the kernels agree with the plain versions, and so do two
   256-token chunked-prefill pieces through the paged model (every K1
   call on its chunk variant);
4c. chunked prefill on the serving path, the JAX bench's chunked
   configuration at full width (``bench.py:1196-1199``): GPT-small at
   2048 positions (int8 export), 8 slots, chunk 16, 64-token pages,
   ``prefill_chunk`` 256, ``step_token_budget`` 384; 32 requests, every
   4th with a 1024-token prompt and the rest 64, 64 new tokens each,
   through the unchunked and the chunked engine in turns (unchunked,
   chunked, chunked, unchunked). Every piece's K1 calls
   must take the chunk variant and every serving kernel must launch;
   an f32 run of the same arrivals (the full width cut to 2 layers)
   must give the unchunked engine's tokens exactly. Prints the short
   requests' time to first token and largest gap between tokens, new
   tokens/s and the engine's step times of each run, and the ratios of
   the two engines' means;
6. training main path: ``lm_pretrain.main`` on a seeded synthetic text
   corpus at the GPT-small width (hidden 768, 12 layers, 12 heads, FFN
   3072, seq 512, batch 16, bf16, Adam 3e-4), 2 epochs x 10 steps with
   ``--export-bundle``; the losses must be finite and fall from epoch 1
   to epoch 2, every training kernel's counter must move, and the
   exported bundle must load and generate on the card; then profiles
   two steady training steps;
7. checks training parity on the card: a 2-layer f32 model trains 3
   steps with the kernels and with ``use_kernels=False`` from one init
   (losses and step-0 gradients agree), and full-width bf16 step-0 loss
   and gradients (whole tree and worst tensor) through the kernels agree
   with the plain versions;
7b. a training step at GPT-2 large's widths (hidden 1280, 20 heads of
   64, FFN 5120; 2 layers, bf16, batch 4 x 128): step-0 loss and
   gradients through the kernels against ``use_kernels=False`` under
   phase 7's bf16 limits, one Adam step, and the K3 and K3b counters
   must move (LayerNorm at D = 1280);
7c. a training step at a head width of 128 (``--hidden-size 1024
   --num-heads 8``, FFN 4096; depth cut to 2 layers, bf16, batch 4 x
   512) against ``use_kernels=False`` under phase 7's bf16 limits, every
   training kernel's counter moving; then a paged bundle of those widths
   served over HTTP for three greedy requests (K2f at D 128 in prefill,
   K1's first design at D 128 in decode) and an f32 copy's engine
   holding the dense ``generate``'s tokens;
8. ResNet-50 training main path: ``Trainer`` on ``ResNet50(norm_variant=
   "fused")`` (bf16 over f32 weights and statistics, Adam 1e-3), 2 epochs
   x 10 steps on one batch of 64 images at 224^2; every K4 counter must
   move by 36 per step (and no K5 counter), the loss must be finite and
   fall from epoch 1 to 2, every running statistic must leave its init,
   and one ``evaluate`` (``train=False``) must launch K4f 36 times and
   nothing else and leave the statistics as they were; then times the
   step, profiles two steps, and times the ``bn`` variant's step (cuDNN
   convs, no port kernel);
9. checks ResNet-50 ``fused`` training parity on the card: one step
   through the kernels against ``use_kernels=False`` from one init with
   every norm3 scale non-zero — f32 at full depth on 8 images of 64^2,
   bf16 on the full path — and every K4 call of the step against its
   plain version on the same inputs;
10. ResNet-50 ``fused3`` training main path, as phase 8: every K4
    counter must move by 36 per step and every K5 counter by 13, and
    ``evaluate`` must launch K4f 36 and K5f 13 times and nothing else;
    then times and profiles the step beside phase 8's;
11. checks ``fused3`` training parity as phase 9, every K4 and K5 call
    held against its plain version;
12. one training step of each other variant (``bn_f32``, ``gn``,
    ``none``, ``nf``, ``nf`` and ``fused3`` with the s2d stem; bf16, 8
    images of 64^2): finite loss, gradients and parameters, and K5
    launched under ``fused3``;
13. prints one ``{"kernels": [...]}`` line, then
14. ``{"ok": true, "device": {...}}`` as the last line.

It takes no arguments. Any failed check exits non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
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
# rounding (a few ulps of O(1) values). bf16: the kernels keep scores
# and accumulators in f32 and round once at the output (bf16 K2f also
# rounds its unnormalised P, as the TPU kernel does), while the plain
# versions round the normalised probabilities (and dequantized pages)
# to bf16 before the P.V product — allow 2 bf16 ulps relative.
# Attention outputs average many values and can be small (|out| ~ 0.05
# in late rows), so bf16 also requires the relative L2 error of the
# whole tensor to stay under 1e-2 (a few bf16 roundings of ~2e-3 each);
# a fault confined to the bf16 instantiation moves that by far more.
TOL = {"float32": dict(atol=5e-5, rtol=1e-5, rel_l2=None),
       "bfloat16": dict(atol=2e-2, rtol=1.6e-2, rel_l2=1e-2)}
# Column sums over 8192 rows (LayerNorm dscale/dbias, f32 on both sides
# from the same inputs, summed in another order): absolute error within
# 1e-4 of the largest reference sum (a few f32 roundings of a sum of
# 8192 terms), and relative L2 within 2e-5.
SUM_REL_MAX, SUM_REL_L2 = 1e-4, 2e-5


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


def graph_ms(fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed, so no host launch cost reaches the device's
    timeline (``cuda_ms`` of eager calls includes it where the host is
    slower than a short kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, warmup=2, iters=3, reps=5) / calls
    del graph
    return ms


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(out, ref, dtype_name: str, what: str, tol=None) -> float:
    import torch

    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    tol = TOL[dtype_name] if tol is None else tol
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


def ptxas_report(build_log: str) -> dict:
    """``{entry function: {"used": "Used ... registers, ...",
    "spill_stores": bytes, "spill_loads": bytes}}`` from ``nvcc
    -Xptxas=-v`` output."""
    import re

    report, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {"used": "", "spill_stores": 0, "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn]["spill_stores"] = int(m.group(1))
            report[fn]["spill_loads"] = int(m.group(2))
        elif "Used " in line:
            report[fn]["used"] = line.split("Used ", 1)[1].strip()
    return report


# -- phase 3: kernels against their plain versions ----------------------------


# LayerNorm widths (D, rows) held against the plain versions: the LM's
# 768 (8192 rows, a training step's, and 8), 1024 (the narrow design's
# widest), GPT-2 large's 1280 and XL's 1600, 4096, and two whose rows
# are not a whole number of 16-byte chunks: 100 (narrow) and 2050 (the
# wide design's scalar loads); 1280 also from a base 2 or 4 bytes off 16
# (the scalar loads again)
LN_CHECK_WIDTHS = ((768, 8192), (768, 8), (1024, 512), (1280, 512),
                   (1600, 512), (4096, 512), (100, 512), (2050, 512))


def _ln_inputs(torch, dev, g, rows, d, dtype, aligned=True):
    """x, r, dy ``[rows, d]`` of ``dtype`` (from a base one element past
    a 16-byte boundary unless ``aligned``), f32 scale and bias."""
    def draw(scale=1.0, shift=0.0):
        t = (torch.randn(rows * d + 1, generator=g, device=dev) * scale
             + shift).to(dtype)
        return (t[:-1] if aligned else t[1:]).view(rows, d)

    x, r, dy = draw(2.0, 0.5), draw(), draw()
    scale, bias = (torch.randn(d, generator=g, device=dev) for _ in range(2))
    return x, r, dy, scale, bias


def _ln_cases(torch, dev, g):
    """``(dtype name, tag, plan, x, r, dy, scale, bias)`` for every
    LayerNorm check, bf16 and f32."""
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d, rows, aligned in (*((d, rows, True)
                                   for d, rows in LN_CHECK_WIDTHS),
                                 (1280, 512, False)):
            x, r, dy, scale, bias = _ln_inputs(torch, dev, g, rows, d, dtype,
                                               aligned)
            check(ln._aligned(x, r) == aligned, "the unaligned case is "
                  "aligned")
            plan = ln.ln_plan(d, dtype, aligned)
            check(aligned or plan.vec == 1, f"D={d} unaligned: {plan}")
            tag = f"{name} [{rows},{d}]{'' if aligned else ' unaligned'}"
            yield name, tag, plan, x, r, dy, scale, bias


def check_layernorm(torch, dev):
    """K3 against ``layernorm_plain`` at every width of
    ``LN_CHECK_WIDTHS``, bf16 and f32, with and without the residual;
    timed at [8192, 768] bf16 with and without it, eager and
    graph-replayed, beside ``F.layer_norm`` (after ``x + r``)."""
    import torch.nn.functional as F

    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    rec = None
    for name, tag, plan, x, r, _, scale, bias in _ln_cases(torch, dev, g):
        log(f"  layernorm {tag}: {plan}")
        for res in (None, r):
            what = f"layernorm {tag}{' +residual' if res is not None else ''}"
            err = compare(ln.fused_layernorm(x, scale, bias, 1e-5, res),
                          ln.layernorm_plain(x, scale, bias, 1e-5, res),
                          name, what)
            if name != "bfloat16" or x.shape != (8192, 768):
                continue
            kern = lambda: ln.fused_layernorm(  # noqa: E731
                x, scale, bias, 1e-5, res)
            w, b = scale.to(x.dtype), bias.to(x.dtype)
            lib = (lambda: F.layer_norm(x, (768,), w, b, 1e-5)  # noqa: E731
                   ) if res is None else (
                lambda: F.layer_norm(x + r, (768,), w, b, 1e-5))
            # x (and r) read and y written once, scale and bias read
            rows_in = 1 if res is None else 2
            nbytes = (rows_in + 1) * x.numel() * x.element_size() + 2 * 768 * 4
            bms, by = bound(nbytes, 8 * x.numel(), "float32")
            shape = ("[8192,768] bf16"
                     + ("" if res is None else " +residual"))
            got = dict(max_abs_err=err, ms=cuda_ms(kern),
                       plain_ms=cuda_ms(lambda: ln.layernorm_plain(
                           x, scale, bias, 1e-5, res)),
                       bound_ms=bms, bound_by=by, library_ms=cuda_ms(lib),
                       graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                       shape=shape)
            log(f"  K3 {got['shape']}: kernel {got['ms']:.4f} ms, "
                f"graph-replayed {got['graph_ms']:.4f}; F.layer_norm"
                f"{'' if res is None else ' after x + r'} "
                f"{got['library_ms']:.4f}, graph-replayed "
                f"{got['library_graph_ms']:.4f}; plain {got['plain_ms']:.4f};"
                f" bound {bms:.4f} ({by})")
            if res is None:
                rec = got
            else:
                rec["residual"] = got
    return rec


def _flash_record(torch, fa, q, k, v, err, shape):
    """K2f, its plain version and SDPA timed on causal bf16 q/k/v, with
    the bound: q/k/v read and out written once plus the f32 lse, and
    4*D operations per unmasked (query, key) pair."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    nbytes = 4 * q.numel() * q.element_size() + b * h * s * 4
    ops = 4 * b * h * d * (s * (s + 1) / 2)
    bms, by = bound(nbytes, ops, str(q.dtype).split(".")[-1])
    return dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=cuda_ms(lib),
                graph_ms=graph_ms(kern), library_graph_ms=graph_ms(lib),
                shape=shape)


def _flash_case(torch, fa, q, k, v, name, what, kv_mask=None, causal=True,
                segs=None):
    """K2f against its plain version: out, the finite lse, and rows with
    no unmasked key 0 with lse +inf. Returns ``(out, lse, max abs err)``."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_mask=kv_mask,
                                      causal=causal, segment_ids=segs)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask=kv_mask,
                                            causal=causal, segment_ids=segs)
    err = compare(out, ref, name, what)
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all())
          and bool(torch.isposinf(lse[~finite]).all()),
          f"{what}: lse masked rows disagree")
    empty = ~finite.transpose(1, 2)  # [B, S, H]
    check(bool((out[empty] == 0).all()), f"{what}: an empty row is not 0")
    compare(lse[finite], ref_lse[finite], "float32", f"{what} lse")
    return out, lse, err


def check_flash(torch, dev):
    """K2f against its plain version in bf16 (the tensor-core kernel) and
    f32 (the CUDA-core one): causal at B=8 S=128 and S=1024; key padding
    + segments + causal with a fully masked batch row; ragged S=200
    (causal) and S=77 (segments, with and without causal and key
    padding), which no tile divides; q/k/v as strided views of one [B, S,
    3, H, D] tensor. Then timed (bf16) at B=8 S=1024 and at the LM
    training shape B=16 S=512."""
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
                rec = _flash_record(torch, fa, q, k, v, err,
                                    "B=8 S=1024 H=12 D=64 causal bf16")
        # key padding + segments, with one fully masked row, and the lse
        q, k, v = (torch.randn(2, 256, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        kv_mask = torch.rand(2, 256, generator=g, device=dev) > 0.2
        kv_mask[1] = False  # batch row 1: no key at all
        segs = (torch.arange(256, device=dev) // 48).to(torch.int32)
        segs = segs[None].repeat(2, 1).contiguous()
        out, lse, _ = _flash_case(torch, fa, q, k, v, name,
                                  f"flash kv_mask+segments {name} B=2 S=256",
                                  kv_mask=kv_mask, segs=segs)
        check(bool((out[1] == 0).all()), "fully masked row is not zero")
        check(bool(torch.isposinf(lse[1]).all()),
              "fully masked row lse is not +inf")
        # ragged lengths: S = 200 causal; S = 77 with segments
        q, k, v = (torch.randn(2, 200, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        _flash_case(torch, fa, q, k, v, name,
                    f"flash causal {name} B=2 S=200 (ragged)")
        q, k, v = (torch.randn(3, 77, 12, 64, generator=g, device=dev
                               ).to(dtype) for _ in range(3))
        segs = (torch.arange(77, device=dev) // 20).to(torch.int32)
        segs = segs[None].repeat(3, 1).contiguous()
        kv_mask = torch.rand(3, 77, generator=g, device=dev) > 0.3
        kv_mask[2, :25] = False  # segment 0 of batch row 2: no key
        _flash_case(torch, fa, q, k, v, name,
                    f"flash segments {name} B=3 S=77 (ragged)",
                    causal=False, segs=segs)
        _flash_case(torch, fa, q, k, v, name,
                    f"flash kv_mask+segments+causal {name} B=3 S=77 "
                    "(ragged, empty rows)", kv_mask=kv_mask, segs=segs)
        # q, k, v as strided views of one fused projection [B, S, 3, H, D]
        qkv = torch.randn(2, 300, 3, 12, 64, generator=g, device=dev
                          ).to(dtype)
        q, k, v = qkv.unbind(2)
        check(not q.is_contiguous() and q.stride(-1) == 1,
              "the strided case is not strided")
        _flash_case(torch, fa, q, k, v, name,
                    f"flash causal {name} B=2 S=300, q/k/v views of [B, S, "
                    "3, H, D]")
    # the LM training shape (12 launches a step)
    q, k, v = (torch.randn(16, 512, 12, 64, generator=g, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    _, _, err = _flash_case(torch, fa, q, k, v, "bfloat16",
                            "flash causal bfloat16 B=16 S=512 H=12 D=64")
    rec["train_shape"] = _flash_record(
        torch, fa, q, k, v, err, "B=16 S=512 H=12 D=64 causal bf16")
    for r in (rec, rec["train_shape"]):
        log(f"  K2f bf16 {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); graph-replayed: "
            f"kernel {r['graph_ms']:.4f}, SDPA {r['library_graph_ms']:.4f}")
    return rec


def check_layernorm_bwd(torch, dev):
    """K3b against ``layernorm_bwd_plain`` at every width of
    ``LN_CHECK_WIDTHS``, bf16 and f32, with and without the residual;
    timed at the training shape [8192, 768] bf16, eager and
    graph-replayed, beside ``native_layer_norm_backward``."""
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(5)
    rec = None
    for name, tag, _, x, r, dy, scale, _ in _ln_cases(torch, dev, g):
        for res in (None, r):
            what = (f"layernorm_bwd {tag}"
                    f"{' +residual' if res is not None else ''}")
            got = ln.layernorm_bwd(dy, x, scale, 1e-5, res)
            want = ln.layernorm_bwd_plain(dy, x, scale, 1e-5, res)
            err = compare(got[0], want[0], name, f"{what} dx")
            for i, sums in ((1, "dscale"), (2, "dbias")):
                tol = dict(atol=SUM_REL_MAX * float(want[i].abs().max()),
                           rtol=0.0, rel_l2=SUM_REL_L2)
                compare(got[i], want[i], "float32", f"{what} {sums}", tol)
            if name == "bfloat16" and x.shape == (8192, 768) and res is None:
                kern = lambda: ln.layernorm_bwd(dy, x, scale,  # noqa: E731
                                                1e-5)
                plain = cuda_ms(lambda: ln.layernorm_bwd_plain(dy, x, scale,
                                                               1e-5))
                # the library yardstick: one call computing the same
                # function, native_layer_norm_backward on the statistics
                # native_layer_norm saves (never called by the port)
                w = scale.to(x.dtype)
                b = torch.zeros_like(w)
                _, mean, rstd = torch.ops.aten.native_layer_norm(
                    x, [768], w, b, 1e-5)
                native = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731,E501
                    dy, x, [768], mean, rstd, w, b, [True, True, True])
                lib = cuda_ms(native)
                # x and dy read, dx written, scale read, dscale and dbias
                # written; ~17 f32 operations per element (statistics,
                # closed form, column sums)
                nbytes = 3 * x.numel() * x.element_size() + 3 * 768 * 4
                bms, by = bound(nbytes, 17 * x.numel(), "float32")
                rec = dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           graph_ms=graph_ms(kern),
                           library_graph_ms=graph_ms(native),
                           shape="[8192,768] bf16")
                log(f"  K3b [8192,768] bf16: kernel {rec['ms']:.4f} ms, "
                    f"graph-replayed {rec['graph_ms']:.4f}; "
                    f"native_layer_norm_backward {lib:.4f}, graph-replayed "
                    f"{rec['library_graph_ms']:.4f}; bound {bms:.4f} ({by})")
    return rec


def _flash_bwd_case(torch, dev, g, dtype, case, b=16, s=512, h=12, d=64):
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev
                                 ).to(dtype) for _ in range(4))
    kv_mask = segs = None
    if case in ("segments", "masked"):
        # documents of 100 tokens, as packed rows carry them
        segs = (torch.arange(s, device=dev) // 100).to(torch.int32)
        segs = segs[None].repeat(b, 1).contiguous()
    if case == "masked":
        kv_mask = torch.rand(b, s, generator=g, device=dev) > 0.1
        kv_mask[:, _empty_row(s)] = False
        kv_mask[_masked_batch(b)] = False  # no key at all
    return q, k, v, dout, kv_mask, segs


def _empty_row(s: int) -> int:
    """A query row that starts a 100-token document, so that under the
    causal mask it sees only its own key: with that key padded it is
    empty (200 at S = 512)."""
    return min(200, (s - 1) // 100 * 100)


def _masked_batch(b: int) -> int:
    return min(3, b - 1)


def _flash_bwd_check(torch, fa, name, tag, q, k, v, dout, kv_mask, segs):
    """K2f's out and lse against the plain version, then K2dq and K2dkv
    against ``flash_attention_bwd_plain`` on the same inputs (q, k, v, dO
    and the forward kernel's out and lse). Returns the errors of dq, dk,
    dv and the backward's inputs."""
    out, lse = fa.flash_attention_fwd(q, k, v, kv_mask, True, segs)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask, True, segs)
    compare(out, ref_out, name, f"flash fwd {tag} out")
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all()),
          f"flash fwd {tag}: lse masked rows disagree")
    compare(lse[finite], ref_lse[finite], "float32", f"flash fwd {tag} lse")
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_dq(dout, q, k, v, lse, delta, kv_mask, True, segs)
    dk, dv = fa.flash_attention_dkv(dout, q, k, v, lse, delta, kv_mask, True,
                                    segs)
    ref = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta, kv_mask,
                                       True, segs)
    errs = tuple(compare(got, want, name, f"flash bwd {tag} {what}")
                 for got, want, what in zip((dq, dk, dv), ref,
                                            ("dq", "dk", "dv")))
    if kv_mask is not None:
        row = _masked_batch(q.shape[0])
        check(bool((dq[row] == 0).all() and (dk[row] == 0).all()
                   and (dv[row] == 0).all()),
              f"flash bwd {tag}: fully masked batch row has a gradient")
        check(bool((dq[:, _empty_row(q.shape[1])] == 0).all()),
              f"flash bwd {tag}: the empty query row has a gradient")
    return errs, lse, delta


def check_flash_bwd(torch, dev):
    """At the training shape B=16 S=512 H=12 D=64 (causal; causal +
    segments; key padding + segments + causal with an empty row and a
    fully masked batch row) and at ragged S = 200 and 77 (the same three
    masks; q/k/v as views of one [B, S, 3, H, D] tensor and an expanded
    dO at S = 200): K2f's out and lse, then K2dq and K2dkv against
    ``flash_attention_bwd_plain``, in bf16 (K2dkv: the tensor-core
    kernel) and f32. Then timed at the training shape, eager and
    replayed from a CUDA graph, beside the plain version and the SDPA
    backward (which computes dQ, dK and dV together) on today's [B, S, H,
    D] views and on contiguous [B, H, S, D] tensors."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(6)
    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s in (512, 200, 77):
            for case in ("causal", "segments", "masked"):
                q, k, v, dout, kv_mask, segs = _flash_bwd_case(
                    torch, dev, g, dtype, case, b=16 if s == 512 else 3, s=s)
                tag = f"{case} {name} B={q.shape[0]} S={s} H=12 D=64"
                if s == 200 and case == "masked":
                    # q/k/v as strided views of one fused projection, and
                    # a cotangent expanded over the heads
                    qkv = torch.randn(3, s, 3, 12, 64, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = qkv.unbind(2)
                    dout = dout[:, :, :1].expand(-1, -1, 12, -1)
                    check(not q.is_contiguous() and dout.stride(2) == 0,
                          "the strided case is not strided")
                    tag += ", q/k/v views of [B, S, 3, H, D], dO expanded"
                errs, lse, delta = _flash_bwd_check(
                    torch, fa, name, tag, q, k, v, dout, kv_mask, segs)
                if dtype == torch.bfloat16 and s == 512 and case == "causal":
                    recs = _flash_bwd_record(torch, fa, q, k, v, dout, lse,
                                             delta, errs)
    return recs


def _flash_bwd_record(torch, fa, q, k, v, dout, lse, delta, errs):
    """K2dq and K2dkv at a causal shape (the bf16 training shape, and
    phase 3's other head widths), eager and graph-replayed, beside the
    plain version and the SDPA backward."""
    import torch.nn.functional as F

    b, s, h, d = q.shape
    name = str(q.dtype).split(".")[-1]
    shape = f"B={b} S={s} H={h} D={d} causal {name.replace('bfloat16', 'bf16')}"
    plain = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, dout, lse, delta, causal=True))
    lib, lib_graph, lib_c, lib_c_graph = _sdpa_bwd_times(torch, F, q, k, v,
                                                         dout)
    log(f"  SDPA backward (dQ + dK + dV) {shape}: "
        f"[B, S, H, D] views {lib:.4f} ms, graph-replayed {lib_graph}; "
        f"contiguous [B, H, S, D] {lib_c:.4f}, graph-replayed "
        f"{lib_c_graph}")
    pairs = b * h * s * (s + 1) / 2  # causal (query, key) pairs
    row = q.numel() * q.element_size()  # one [B, S, H, D] tensor
    vecs = 2 * b * h * s * 4  # lse and delta
    libs = dict(library_ms=lib, library_graph_ms=lib_graph,
                library_contiguous_ms=lib_c,
                library_contiguous_graph_ms=lib_c_graph)
    dq_fn = lambda: fa.flash_attention_dq(  # noqa: E731
        dout, q, k, v, lse, delta, causal=True)
    dkv_fn = lambda: fa.flash_attention_dkv(  # noqa: E731
        dout, q, k, v, lse, delta, causal=True)
    # K2dq reads q, k, v, dO, lse, delta and writes dq; s, dp and the dq
    # update are 3 products of D per pair. K2dkv writes dk and dv; s, dp,
    # dv and dk are 4 products of D per pair.
    recs = {}
    for key, fn, nbytes, ops, err in (
            ("flash_attention_dq", dq_fn, 5 * row + vecs, 6 * d * pairs,
             errs[0]),
            ("flash_attention_dkv", dkv_fn, 6 * row + vecs, 8 * d * pairs,
             max(errs[1], errs[2]))):
        bms, by = bound(nbytes, ops, name)
        recs[key] = dict(max_abs_err=err, ms=cuda_ms(fn), plain_ms=plain,
                         bound_ms=bms, bound_by=by, graph_ms=graph_ms(fn),
                         shape=shape, **libs)
        r = recs[key]
        log(f"  {key} {shape}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}, plain {plain:.4f}, bound {bms:.4f} ({by})")
    return recs


def _sdpa_bwd_times(torch, F, q, k, v, dout):
    """The SDPA backward (dQ, dK and dV together), eager and
    graph-replayed, on transposed [B, S, H, D] views and on contiguous
    [B, H, S, D] copies. Graph-replayed: forward and backward captured
    together, less the forward alone; autograd's backward syncs with the
    stream its leaves were made on, so the captured function makes its
    own leaves (views of the inputs). A capture that fails leaves that
    time None ("not measured") and is logged: it is a yardstick, not a
    kernel of the port."""
    times = []
    for contiguous in (False, True):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        dt = dout.transpose(1, 2)
        if contiguous:
            qt, kt, vt, dt = (t.contiguous() for t in (qt, kt, vt, dt))
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        y = F.scaled_dot_product_attention(*leaves, is_causal=True)
        eager = cuda_ms(lambda: torch.autograd.grad(
            y, leaves, dt, retain_graph=True))

        def fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def fwd_bwd():
            own = [t.detach().requires_grad_() for t in (qt, kt, vt)]
            torch.autograd.grad(F.scaled_dot_product_attention(
                *own, is_causal=True), own, dt)

        try:
            graphed = max(graph_ms(fwd_bwd) - graph_ms(fwd), 0.0)
        except RuntimeError as exc:  # torch.AcceleratorError included
            log(f"  SDPA backward graph capture failed, not measured: "
                f"{str(exc).splitlines()[0]}")
            torch.cuda.synchronize()
            graphed = None
        times += [eager, graphed]
    return times


# Head widths beside GPT-small's 64 that phase 3 holds K2f, K2dq and
# K2dkv at, with the design flash_plan must pick for each dtype: 128 (a
# Llama-width head: bf16 on the tensor cores, f32 on the CUDA cores) and
# 32 and 80 (CUDA-core widths: 32 is instantiated, 80 runs the 128-wide
# instantiation with its loads masked). Each is timed (bf16) at B=16
# S=512 H=8, a training batch of the LM's sequence length.
FLASH_WIDTHS = ((128, {"bfloat16": "wgmma", "float32": "simt"}),
                (32, {"bfloat16": "simt", "float32": "simt"}),
                (80, {"bfloat16": "simt", "float32": "simt"}))
FLASH_TIMED_WIDTHS = (128, 80)


def check_flash_widths(torch, dev):
    """K2f, K2dq and K2dkv at head widths 128, 32 and 80 in bf16 and f32
    against their plain versions: causal at B=2 S=200 H=4 (ragged), key
    padding + segments + causal with an empty row and a fully masked
    batch row at B=3 S=77, and q/k/v as views of one [B, S, 3, H, D]
    tensor with a cotangent expanded over the heads; each call's launch
    counter must move and flash_plan must pick the expected design. Then
    the bf16 kernels at D 128 (tensor cores) and D 80 (CUDA cores) are
    timed at B=16 S=512 H=8, eager and graph-replayed, beside their bound,
    the plain versions and SDPA forward and backward. Returns ``{kernel:
    {"d128": record, "d80": record}}``."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(16)
    recs = {"flash_attention_fwd": {}, "flash_attention_dq": {},
            "flash_attention_dkv": {}}
    for d, designs in FLASH_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            plan = fa.flash_plan(d, dtype)
            check(plan.design == designs[name],
                  f"flash_plan({d}, {name}) = {plan}, expected the "
                  f"{designs[name]} design")
            log(f"  flash D={d} {name}: plan {plan.design} at width "
                f"{plan.width}")
            for b, s, case in ((2, 200, "causal"), (3, 77, "masked"),
                               (3, 77, "views")):
                q, k, v, dout, kv_mask, segs = _flash_bwd_case(
                    torch, dev, g, dtype, "causal" if case == "views"
                    else case, b=b, s=s, h=4, d=d)
                tag = f"{case} {name} B={b} S={s} H=4 D={d}"
                if case == "views":
                    qkv = torch.randn(b, s, 3, 4, d, generator=g,
                                      device=dev).to(dtype)
                    q, k, v = qkv.unbind(2)
                    dout = dout[:, :, :1].expand(-1, -1, 4, -1)
                before = (fa.launches, fa.dq_launches, fa.dkv_launches)
                _flash_bwd_check(torch, fa, name, tag, q, k, v, dout,
                                 kv_mask, segs)
                check((fa.launches, fa.dq_launches, fa.dkv_launches)
                      == tuple(n + 1 for n in before),
                      f"flash {tag}: a kernel was not launched")
    for d in FLASH_TIMED_WIDTHS:
        for key, rec in time_flash_width(torch, dev, g, d).items():
            recs[key][f"d{d}"] = rec
    return recs


def time_flash_width(torch, dev, g, d, b=16, s=512, h=8, dtype=None):
    """K2f, K2dq and K2dkv at head width ``d`` (bf16 unless ``dtype``;
    causal, B=16 S=512 H=8 by default), checked against their plain
    versions, then timed eager and graph-replayed beside their bound, the
    plain versions and SDPA forward and backward. Returns ``{kernel:
    record}``."""
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    name = str(dtype).split(".")[-1]
    q, k, v, dout, _, _ = _flash_bwd_case(
        torch, dev, g, dtype, "causal", b=b, s=s, h=h, d=d)
    errs, lse, delta = _flash_bwd_check(
        torch, fa, name, f"causal {name} B={b} S={s} H={h} D={d}",
        q, k, v, dout, None, None)
    out = fa.flash_attention_fwd(q, k, v, causal=True)[0]
    err = float((out.float() - fa.flash_attention_plain(
        q, k, v, causal=True)[0].float()).abs().max())
    fwd = _flash_record(torch, fa, q, k, v, err,
                        f"B={b} S={s} H={h} D={d} causal {name}")
    log(f"  K2f {name} {fwd['shape']} ({fa.flash_plan(d, q.dtype).design}"
        f"): kernel {fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f}, "
        f"SDPA {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f} "
        f"({fwd['bound_by']}); graph-replayed: kernel "
        f"{fwd['graph_ms']:.4f}, SDPA {fwd['library_graph_ms']:.4f}")
    return {"flash_attention_fwd": fwd,
            **_flash_bwd_record(torch, fa, q, k, v, dout, lse, delta, errs)}


# ResNet-50's 36 fused 1x1 convs at batch 64 (224^2), as (M, K, N,
# transform, count): M rows of NHWC pixels, K input and N output
# channels, "relu" where the conv reads relu(norm(x)) (conv3), and how
# many of the 36 calls of one forward have the shape
RESNET50_K4_SHAPES = (
    (200704, 64, 64, None, 1), (200704, 64, 256, "relu", 3),
    (200704, 64, 256, None, 1), (200704, 256, 64, None, 2),
    (200704, 256, 128, None, 1), (50176, 128, 512, "relu", 4),
    (50176, 256, 512, None, 1), (50176, 512, 128, None, 3),
    (50176, 512, 256, None, 1), (12544, 256, 1024, "relu", 6),
    (12544, 512, 1024, None, 1), (12544, 1024, 256, None, 5),
    (12544, 1024, 512, None, 1), (3136, 512, 2048, "relu", 3),
    (3136, 1024, 2048, None, 1), (3136, 2048, 512, None, 2))
# the shapes held against the plain versions (bf16 and f32): two of
# stage 1, one of stage 3, one of stage 4, a ragged one with the affine
# transform and no relu, and one whose K and N are not multiples of 8
# (the masked edge path of the bf16 kernels)
K4_CHECK_SHAPES = ((200704, 256, 64, None), (200704, 64, 256, "relu"),
                   (12544, 1024, 256, None), (3136, 512, 2048, "relu"),
                   (1000, 72, 40, "affine"), (1000, 12, 20, "relu"))


def _k4_tol(ref, dtype_name: str, over_m: bool = False):
    """K4 outputs against the plain versions: both sum the same f32
    products in another order, then round once to the output type, so a
    bf16 output may sit one rounding (2^-7 relative) apart, and the
    whole tensor within 1e-3 relative L2 (a few such roundings); f32
    within 1e-5 relative, element and L2, for sums over K or N (<= 2048
    terms), and 1e-4 for dw's sums over M (up to 200,704 terms: f32
    rounding of a sum of n zero-mean terms grows as sqrt(n) eps, 2.7e-5
    at that n). Near-zero outputs (cancellation) get an absolute slack of
    1e-4 (bf16) or 1e-5 (f32) of the largest reference element."""
    top = float(ref.abs().max())
    if dtype_name == "bfloat16":
        return dict(atol=1e-4 * top, rtol=2.0 ** -7, rel_l2=1e-3)
    rel = 1e-4 if over_m else 1e-5
    return dict(atol=1e-5 * top, rtol=rel, rel_l2=rel)


def _sum_tol(ref):
    """f32 column sums over up to 200,704 rows in another order."""
    return dict(atol=SUM_REL_MAX * float(ref.abs().max()), rtol=0.0,
                rel_l2=SUM_REL_L2)


def _k4_inputs(torch, dev, g, m, k, n, dtype, transform):
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=g, device=dev) / math.sqrt(k)).to(dtype)
    dy = torch.randn(m, n, generator=g, device=dev).to(dtype)
    a = b = None
    if transform is not None:
        a = torch.rand(k, generator=g, device=dev) + 0.5
        b = torch.randn(k, generator=g, device=dev) * 0.5
    return x, w, dy, a, b


def check_fused_matmul(torch, dev):
    """K4f, K4dx and K4dw against their plain versions at ResNet-50's
    shapes in bf16 and f32; then each kernel, its plain version and a
    ``torch.matmul`` of the same product (cuBLAS, operands prepared
    outside the timed region: no transform, mask or statistics) timed
    on all 16 distinct shapes of a step, summed over its 36 calls,
    eager and replayed from a CUDA graph (the bf16 kernels are all on
    the tensor cores)."""
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    g = torch.Generator(device=dev).manual_seed(8)
    errs = {"fused_matmul_fwd": 0.0, "fused_matmul_dx": 0.0,
            "fused_matmul_dw": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for m, k, n, transform in K4_CHECK_SHAPES:
            x, w, dy, a, b = _k4_inputs(torch, dev, g, m, k, n, dtype,
                                        transform)
            relu = transform == "relu"
            tag = f"k4 {name} M={m} K={k} N={n} {transform or 'plain'}"
            y, st = fm.norm_relu_matmul_fwd(x, w, a, b, relu, True)
            ry, rs, rss = fm.norm_relu_matmul_plain(x, w, a, b, relu=relu,
                                                    want_stats=True)
            rst = torch.stack([rs, rss])
            errs["fused_matmul_fwd"] = max(errs["fused_matmul_fwd"], compare(
                y, ry, name, f"{tag} K4f y", _k4_tol(ry, name)))
            compare(st, rst, "float32", f"{tag} K4f stats", _sum_tol(rst))
            y0, st0 = fm.norm_relu_matmul_fwd(x, w, a, b, relu, False)
            check(st0 is None and torch.equal(y0, y),
                  f"{tag}: K4f without statistics differs")
            dx, ds = fm.norm_relu_matmul_dx(dy, w, x, a, b, relu)
            rdx, rds = fm.norm_relu_matmul_dx_plain(dy, w, x, a, b, relu)
            errs["fused_matmul_dx"] = max(errs["fused_matmul_dx"], compare(
                dx, rdx, name, f"{tag} K4dx dx", _k4_tol(rdx, name)))
            if a is not None:
                compare(ds, rds, "float32", f"{tag} K4dx da/db", _sum_tol(rds))
            dw = fm.norm_relu_matmul_dw(x, dy, a, b, relu)
            rdw = fm.norm_relu_matmul_dw_plain(x, dy, a, b, relu)
            errs["fused_matmul_dw"] = max(errs["fused_matmul_dw"], compare(
                dw, rdw, name, f"{tag} K4dw dw",
                _k4_tol(rdw, name, over_m=True)))
            del x, w, dy, y, ry, dx, rdx, dw, rdw
        torch.cuda.empty_cache()

    totals = {key: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0, bytes_ms=0.0) for key in errs}
    # each kernel and its matmul also graph-replayed
    graphed = {key: dict(graph_ms=0.0, library_graph_ms=0.0) for key in errs}
    for m, k, n, transform, count in RESNET50_K4_SHAPES:
        x, w, dy, a, b = _k4_inputs(torch, dev, g, m, k, n, torch.bfloat16,
                                    transform)
        relu = transform == "relu"
        xn = x if a is None else torch.relu(x.float() * a + b).to(x.dtype)
        wt = w.t().contiguous()
        xnt = xn.t().contiguous()
        s = 2  # bytes per bf16 element
        ops = 2.0 * m * k * n
        vec = 2 * k * 4 if a is not None else 0  # a and b
        work = {
            # reads x, w (a, b); writes y and the [2, N] statistics
            "fused_matmul_fwd": (
                lambda: fm.norm_relu_matmul_fwd(x, w, a, b, relu, True),
                lambda: fm.norm_relu_matmul_plain(x, w, a, b, relu=relu,
                                                  want_stats=True),
                lambda: torch.matmul(xn, w),
                (m * k + k * n + m * n) * s + vec + 2 * n * 4),
            # reads dy, w (and x, a, b with a transform); writes dx (and
            # the [2, K] d a, d b)
            "fused_matmul_dx": (
                lambda: fm.norm_relu_matmul_dx(dy, w, x, a, b, relu),
                lambda: fm.norm_relu_matmul_dx_plain(dy, w, x, a, b, relu),
                lambda: torch.matmul(dy, wt),
                (m * n + k * n + m * k) * s
                + (m * k * s + vec + 2 * k * 4 if a is not None else 0)),
            # reads x, dy (a, b); writes dw
            "fused_matmul_dw": (
                lambda: fm.norm_relu_matmul_dw(x, dy, a, b, relu),
                lambda: fm.norm_relu_matmul_dw_plain(x, dy, a, b, relu),
                lambda: torch.matmul(xnt, dy),
                (m * k + m * n + k * n) * s + vec),
        }
        line = []
        for key, (kern, plain, lib, nbytes) in work.items():
            ms = cuda_ms(kern, warmup=1, iters=3, reps=3)
            pms = cuda_ms(plain, warmup=1, iters=2, reps=3)
            lms = cuda_ms(lib, warmup=1, iters=3, reps=3)
            bms, _ = bound(nbytes, ops, "bfloat16")
            tot = totals[key]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * pms
            tot["library_ms"] += count * lms
            tot["bound_ms"] += count * bms
            tot["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += count * ops / PEAK_OPS["bfloat16"] * 1e3
            gms, glms = graph_ms(kern, 5), graph_ms(lib, 5)
            graphed[key]["graph_ms"] += count * gms
            graphed[key]["library_graph_ms"] += count * glms
            line.append(f"{key[13:]} {ms:.4f}/{pms:.4f}/{lms:.4f}/{bms:.4f} "
                        f"graph-replayed {gms:.4f}/{glms:.4f}")
        log(f"  k4 bf16 M={m} K={k} N={n} {transform or 'plain'} x{count} "
            f"(kernel/plain/matmul/bound ms): {', '.join(line)}")
        del x, w, dy, xn, wt, xnt
    torch.cuda.empty_cache()
    recs = {}
    for key, tot in totals.items():
        recs[key] = dict(
            max_abs_err=errs[key], ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            shape="the 36 calls of one ResNet-50 step, batch 64, bf16 "
                  "(summed)")
    for key, times in graphed.items():
        recs[key].update(times)
    return recs


# ResNet-50's 13 stride-1 3x3 convs at batch 64 (224^2), as (B, H, W,
# K = N, count): the input [B, H, W, K] of conv2 in the stride-1 blocks
# of each stage, and how many of the 13 calls of one forward have it
RESNET50_K5_SHAPES = ((64, 56, 56, 64, 3), (64, 28, 28, 128, 3),
                      (64, 14, 14, 256, 5), (64, 7, 7, 512, 2))
# the shapes held against the plain versions (bf16 and f32): the four
# stages, with and without the transform, and a ragged one (H, W not
# multiples of anything, K and N not multiples of the 16 / 64 tiles,
# tiles of 128 pixels crossing rows and images) in all three modes, and
# one whose K and N are not multiples of 8 (bf16 K5f's masked edge path)
K5_CHECK_SHAPES = tuple((b, h, w, k, k, t) for b, h, w, k, _ in
                        RESNET50_K5_SHAPES for t in ("relu", None)) + tuple(
    (3, 9, 5, 48, 80, t) for t in ("relu", "affine", None)) + (
    (2, 6, 7, 12, 20, "relu"),)


def _k5_tol(ref, dtype_name: str, over_m: bool = False):
    """K5 outputs against the plain versions: as :func:`_k4_tol`, but the
    f32 sums of y and dx run over 9 x K terms (up to 4,608; f32 rounding
    of such a sum grows as sqrt(n) eps, 4e-6 at that n): 2e-5 relative.
    dw's sums over the pixels (up to 200,704 terms a tap) keep 1e-4."""
    if dtype_name == "bfloat16" or over_m:
        return _k4_tol(ref, dtype_name, over_m)
    return dict(atol=1e-5 * float(ref.abs().max()), rtol=2e-5, rel_l2=2e-5)


def _k5_inputs(torch, dev, g, b, h, w, k, n, dtype, transform):
    x = torch.randn(b, h, w, k, generator=g, device=dev).to(dtype)
    wt = (torch.randn(3, 3, k, n, generator=g, device=dev)
          / math.sqrt(9 * k)).to(dtype)
    dy = torch.randn(b, h, w, n, generator=g, device=dev).to(dtype)
    a = bb = None
    if transform is not None:
        a = torch.rand(k, generator=g, device=dev) + 0.5
        bb = torch.randn(k, generator=g, device=dev) * 0.5
    return x, wt, dy, a, bb


def check_fused_conv3(torch, dev):
    """K5f, K5dx and K5dw against their plain versions at ResNet-50's
    stride-1 3x3 shapes and a ragged one, in bf16 and f32, with and
    without the transform and the statistics; then each kernel, its plain
    version and a cuDNN yardstick (bf16, channels-last: ``F.conv2d`` on
    the materialised ``relu(x*a+b)``, and the conv's ``conv2d_input`` and
    ``conv2d_weight`` gradients; operands prepared outside the timed
    region) timed at the four stage shapes, summed over the 13 calls of
    one step."""
    import torch.nn.functional as F
    from torch.nn import grad as conv_grad

    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    g = torch.Generator(device=dev).manual_seed(9)
    errs = {"fused_conv3_fwd": 0.0, "fused_conv3_dx": 0.0,
            "fused_conv3_dw": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, w, k, n, transform in K5_CHECK_SHAPES:
            x, wt, dy, a, bb = _k5_inputs(torch, dev, g, b, h, w, k, n, dtype,
                                          transform)
            relu = transform == "relu"
            tag = (f"k5 {name} x=[{b},{h},{w},{k}] N={n} "
                   f"{transform or 'plain'}")
            y, st = fc.conv3_fwd(x, wt, a, bb, relu, True)
            ry, rst = fc.conv3_fwd_plain(x, wt, a, bb, relu, True)
            errs["fused_conv3_fwd"] = max(errs["fused_conv3_fwd"], compare(
                y, ry, name, f"{tag} K5f y", _k5_tol(ry, name)))
            compare(st, rst, "float32", f"{tag} K5f stats", _sum_tol(rst))
            y0, st0 = fc.conv3_fwd(x, wt, a, bb, relu, False)
            check(st0 is None and torch.equal(y0, y),
                  f"{tag}: K5f without statistics differs")
            dx, ds = fc.conv3_dx(dy, wt, x, a, bb, relu)
            rdx, rds = fc.conv3_dx_plain(dy, wt, x, a, bb, relu)
            errs["fused_conv3_dx"] = max(errs["fused_conv3_dx"], compare(
                dx, rdx, name, f"{tag} K5dx dx", _k5_tol(rdx, name)))
            check((ds is None) == (a is None), f"{tag}: K5dx d a / d b")
            if a is not None:
                compare(ds, rds, "float32", f"{tag} K5dx da/db", _sum_tol(rds))
            dw = fc.conv3_dw(x, dy, a, bb, relu)
            rdw = fc.conv3_dw_plain(x, dy, a, bb, relu)
            errs["fused_conv3_dw"] = max(errs["fused_conv3_dw"], compare(
                dw, rdw, name, f"{tag} K5dw dw",
                _k5_tol(rdw, name, over_m=True)))
            del x, wt, dy, y, ry, y0, dx, rdx, dw, rdw
        torch.cuda.empty_cache()

    totals = {key: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0, bytes_ms=0.0) for key in errs}
    # each kernel (the bf16 ones are the tensor-core kernels) and cuDNN
    # also graph-replayed
    graphed = {key: dict(graph_ms=0.0, library_graph_ms=0.0)
               for key in ("fused_conv3_fwd", "fused_conv3_dx",
                           "fused_conv3_dw")}
    for b, h, w, k, count in RESNET50_K5_SHAPES:
        n = k
        x, wt, dy, a, bb = _k5_inputs(torch, dev, g, b, h, w, k, n,
                                      torch.bfloat16, "relu")
        xn = torch.relu(x.float() * a + bb).to(x.dtype)
        # channels-last NCHW views of the NHWC tensors, OIHW weights
        xn_c, x_c, dy_c = (t.permute(0, 3, 1, 2) for t in (xn, x, dy))
        w_c = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        m, s = b * h * w, 2  # pixels, bytes per bf16 element
        ops = 2.0 * m * 9 * k * n
        vec = 2 * k * 4  # a and b
        work = {
            # reads x, w, a, b; writes y and the [2, N] statistics
            "fused_conv3_fwd": (
                lambda: fc.conv3_fwd(x, wt, a, bb, True, True),
                lambda: fc.conv3_fwd_plain(x, wt, a, bb, True, True),
                lambda: F.conv2d(xn_c, w_c, padding=1),
                (m * k + 9 * k * n + m * n) * s + vec + 2 * n * 4),
            # reads dy, w, x, a, b; writes dx and the [2, K] d a, d b
            "fused_conv3_dx": (
                lambda: fc.conv3_dx(dy, wt, x, a, bb, True),
                lambda: fc.conv3_dx_plain(dy, wt, x, a, bb, True),
                lambda: conv_grad.conv2d_input(x_c.shape, w_c, dy_c,
                                               padding=1),
                (m * n + 9 * k * n + 2 * m * k) * s + vec + 2 * k * 4),
            # reads x, dy, a, b; writes dw
            "fused_conv3_dw": (
                lambda: fc.conv3_dw(x, dy, a, bb, True),
                lambda: fc.conv3_dw_plain(x, dy, a, bb, True),
                lambda: conv_grad.conv2d_weight(xn_c, w_c.shape, dy_c,
                                                padding=1),
                (m * k + m * n + 9 * k * n) * s + vec),
        }
        line = []
        for key, (kern, plain, lib, nbytes) in work.items():
            ms = cuda_ms(kern, warmup=1, iters=3, reps=3)
            pms = cuda_ms(plain, warmup=1, iters=2, reps=3)
            lms = cuda_ms(lib, warmup=1, iters=3, reps=3)
            bms, _ = bound(nbytes, ops, "bfloat16")
            tot = totals[key]
            tot["ms"] += count * ms
            tot["plain_ms"] += count * pms
            tot["library_ms"] += count * lms
            tot["bound_ms"] += count * bms
            tot["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
            tot["ops_ms"] += count * ops / PEAK_OPS["bfloat16"] * 1e3
            line.append(f"{key[12:]} {ms:.4f}/{pms:.4f}/{lms:.4f}/{bms:.4f}")
            if key in graphed:
                gms, glms = graph_ms(kern, 5), graph_ms(lib, 5)
                graphed[key]["graph_ms"] += count * gms
                graphed[key]["library_graph_ms"] += count * glms
                line.append(f"{key[12:]} graph-replayed {gms:.4f}/{glms:.4f}")
        log(f"  k5 bf16 x=[{b},{h},{w},{k}] N={n} relu x{count} "
            f"(kernel/plain/cudnn/bound ms): {', '.join(line)}")
        del x, wt, dy, xn, xn_c, x_c, dy_c, w_c
    torch.cuda.empty_cache()
    recs = {}
    for key, tot in totals.items():
        recs[key] = dict(
            max_abs_err=errs[key], ms=tot["ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], bound_ms=tot["bound_ms"],
            bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                      else "operations"),
            shape="the 13 calls of one ResNet-50 step, batch 64, bf16 "
                  "(summed)")
    for key, times in graphed.items():
        recs[key].update(times)
    return recs


# K1's checked cases (H_kv, S, int8 pages, fills) at H = 12, 8 slots of
# 16 pages of 64 tokens: decode (S = 1) and verify-sized chunks (S = 8),
# the decode variant; S = 256 (a chunked-prefill piece of GPT-small: R =
# 256 rows, two 128-row blocks) and S = 512 at 12/4 GQA (R = 1536), the
# chunk variant for a bf16 query and the first design for f32; S = 256
# with every fill <= 128, so that the first row block of every slot sees
# no key and must give zeros; the serving decode shape (every slot at
# 716, the phase-4 prompts after 16 steps); and fills on the decode
# variant's split boundaries (SPLIT_FILLS: a split's last entry, one
# past it, the table's end)
PAGED_FILLS = (0, 1, 63, 64, 65, 500, 960, 1024)
SERVE_FILLS = (716,) * 8
SPLIT_FILLS = "split"
PAGED_CASES = ((12, 1, False, PAGED_FILLS), (4, 1, False, PAGED_FILLS),
               (12, 1, True, PAGED_FILLS), (4, 8, True, PAGED_FILLS),
               (12, 8, False, PAGED_FILLS), (12, 256, False, PAGED_FILLS),
               (12, 256, True, PAGED_FILLS), (4, 512, False, PAGED_FILLS),
               (4, 512, True, PAGED_FILLS),
               (12, 256, False, (0, 1, 63, 64, 100, 127, 128, 128)),
               (12, 1, False, SERVE_FILLS), (12, 1, True, SERVE_FILLS),
               (12, 1, False, SPLIT_FILLS), (12, 1, True, SPLIT_FILLS),
               (4, 8, False, SPLIT_FILLS))


def _split_fills(torch, pa, hkv, s):
    """Fills on the decode plan's split boundaries at this shape (8
    slots, H = 12, 16 pages of 64 tokens; the split does not depend on
    the dtypes): empty, a split's entries full (pages_per_split x P) and
    one token past them, two splits less one token, every entry (MP x
    P), and three others."""
    plan = pa.paged_plan(8, s, 12, hkv, 64, 64, 16, torch.bfloat16,
                         torch.bfloat16)
    edge = plan.pages_per_split * 64
    return (0, edge, edge + 1, 2 * edge - 1, 1024, 65, 700, s)


def _paged_case(torch, dev, g, dtype, hkv, s, quant, fills=PAGED_FILLS,
                h=12, d=64):
    n, p, mp = 128, 64, 16
    fills = torch.tensor(fills, dtype=torch.int32, device=dev)
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


def _paged_record(torch, pa, q, kp, vp, table, fills, err, shape):
    """Times of bf16 K1 and of SDPA over the gathered pages, eager and
    graph-replayed, and the bound, at one shape."""
    kern = lambda: pa.paged_attention_chunk(q, kp, vp, table,  # noqa: E731
                                            fills)
    lib = lambda: _sdpa_over_gathered(torch, q, kp, vp, table,  # noqa: E731
                                      fills)
    bms, by = _paged_bound(q, kp, table, fills)
    return dict(max_abs_err=err, ms=cuda_ms(kern), graph_ms=graph_ms(kern),
                plain_ms=cuda_ms(lambda: pa.paged_attention_chunk_plain(
                    q, kp, vp, table, fills), iters=3, reps=3),
                library_ms=cuda_ms(lib), library_graph_ms=graph_ms(lib),
                bound_ms=bms, bound_by=by, shape=shape)


def check_paged(torch, dev):
    """K1 against ``paged_attention_chunk_plain`` in every case of
    ``PAGED_CASES``, bf16 and f32 (a query with no key, and the empty
    slot, exactly zero), each call's variant the one ``paged_plan``
    names; timed, with SDPA over the gathered pages and the bound, at the
    checked shape (S = 1, fills {0..1024}), the serving decode shape, the
    full pool and the 256-token piece, eager and graph-replayed."""
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    # the S <= 8 cases draw from their own generator, the row-block cases
    # from another
    g = torch.Generator(device=dev).manual_seed(3)
    g_rows = torch.Generator(device=dev).manual_seed(4)
    rec, timed = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for hkv, s, quant, fill_list in PAGED_CASES:
            if fill_list == SPLIT_FILLS:
                fill_list = _split_fills(torch, pa, hkv, s)
            q, kp, vp, table, fills, ks, vs = _paged_case(
                torch, dev, g if s <= 8 else g_rows, dtype, hkv, s, quant,
                fill_list)
            plan = pa.paged_plan(8, s, 12, hkv, 64, 64, 16, dtype, kp.dtype)
            if s <= 8:
                check(plan.variant == "decode",
                      f"K1 at S={s} takes the {plan.variant} variant")
            before_variants = dict(pa.variant_launches)
            out = pa.paged_attention_chunk(q, kp, vp, table, fills, ks, vs)
            ref = pa.paged_attention_chunk_plain(q, kp, vp, table, fills,
                                                 ks, vs)
            check(pa.variant_launches[plan.variant]
                  == before_variants[plan.variant] + 1,
                  f"K1 did not launch its {plan.variant} variant")
            tag = (f"paged {name} slots=8 N=128 P=64 H=12 Hkv={hkv} S={s}"
                   f"{' int8' if quant else ''} fills {list(fill_list)} "
                   f"({plan.variant}: {plan.blocks} row blocks of "
                   f"{plan.rows}, {plan.splits} splits of "
                   f"{plan.pages_per_split} pages, {plan.smem} B)")
            err = compare(out, ref, name, tag)
            check(bool((out[0] == 0).all()) or fill_list[0] != 0,
                  "empty slot is not zero")
            before = (fills[:, None] - s + torch.arange(s, device=dev)) < 0
            check(bool((out[before] == 0).all()),
                  f"{tag}: a query with no key is not zero")
            if dtype != torch.bfloat16 or quant or hkv != 12:
                continue
            if (s, fill_list) == (1, PAGED_FILLS):
                rec = _paged_record(torch, pa, q, kp, vp, table, fills, err,
                                    "8 slots, fills {0..1024}, S=1 bf16")
            elif (s, fill_list) == (1, SERVE_FILLS):
                timed["decode_shape"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, err,
                    "8 slots at fill 716, S=1 bf16")
                q, kp, vp, table, fills, _, _ = _paged_case(
                    torch, dev, g, dtype, hkv, s, quant, (1024,) * 8)
                timed["full_pool"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, compare(
                        pa.paged_attention_chunk(q, kp, vp, table, fills),
                        pa.paged_attention_chunk_plain(q, kp, vp, table,
                                                       fills), name,
                        "paged bfloat16 8 slots at fill 1024, S=1"),
                    "8 slots at fill 1024, S=1 bf16")
            elif (s, fill_list) == (256, PAGED_FILLS):
                timed["piece"] = _paged_record(
                    torch, pa, q, kp, vp, table, fills, err,
                    "8 slots, fills {0..1024}, S=256 bf16")
    rec.update(timed)
    for r in (rec, *timed.values()):
        log(f"  K1 {r['shape']}: kernel {r['ms']:.4f} ms, graph-replayed "
            f"{r['graph_ms']:.4f}; SDPA over gathered pages "
            f"{r['library_ms']:.4f}, graph-replayed "
            f"{r['library_graph_ms']:.4f}; plain {r['plain_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    return rec


def check_paged_d128(torch, dev):
    """K1 at head_dim 128 (8 heads, the phase-7c model's decode): its
    decode and chunk variants are built for head_dim 64, so the plan
    takes the first design (``rows``), which takes any head_dim. Decode
    (S = 1) at fills {0..1024} and at the serving shape (8 slots at 716),
    and a 256-token piece, bf16 and f32, float and int8 pages, against
    the plain version; timed (bf16, the serving decode shape) beside SDPA
    over the gathered pages and the bound."""
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(17)
    rec = None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s, quant, fill_list in ((1, False, PAGED_FILLS),
                                    (1, True, PAGED_FILLS),
                                    (1, False, SERVE_FILLS),
                                    (256, False, PAGED_FILLS)):
            q, kp, vp, table, fills, ks, vs = _paged_case(
                torch, dev, g, dtype, 8, s, quant, fill_list, h=8, d=128)
            plan = pa.paged_plan(8, s, 8, 8, 128, 64, 16, dtype, kp.dtype)
            check(plan.variant == "rows",
                  f"K1 at D=128 S={s} takes the {plan.variant} variant")
            before = pa.variant_launches["rows"]
            out = pa.paged_attention_chunk(q, kp, vp, table, fills, ks, vs)
            ref = pa.paged_attention_chunk_plain(q, kp, vp, table, fills,
                                                 ks, vs)
            check(pa.variant_launches["rows"] == before + 1,
                  "K1 at D=128 did not launch its first design")
            tag = (f"paged {name} slots=8 N=128 P=64 H=Hkv=8 D=128 S={s}"
                   f"{' int8' if quant else ''} fills {list(fill_list)} "
                   f"(rows: {plan.blocks} row blocks of {plan.rows})")
            err = compare(out, ref, name, tag)
            if (dtype, s, fill_list) == (torch.bfloat16, 1, SERVE_FILLS):
                rec = _paged_record(torch, pa, q, kp, vp, table, fills, err,
                                    "8 slots at fill 716, H=8 D=128, S=1 "
                                    "bf16 (first design)")
    log(f"  K1 {rec['shape']}: kernel {rec['ms']:.4f} ms, graph-replayed "
        f"{rec['graph_ms']:.4f}; SDPA over gathered pages "
        f"{rec['library_ms']:.4f}, graph-replayed "
        f"{rec['library_graph_ms']:.4f}; plain {rec['plain_ms']:.4f}; bound "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
    return rec


def _sdpa_over_gathered(torch, q, kp, vp, table, fills):
    """Library yardstick (never called by the port): gather every table
    page, then ``scaled_dot_product_attention`` with each query row's
    causal key mask (query ``s`` at ``fill - S + s``)."""
    import torch.nn.functional as F

    n, p, hkv, d = kp.shape
    b, s, h, _ = q.shape
    safe = table.long().clamp(0, n - 1)
    k = kp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    v = vp[safe].reshape(b, -1, hkv, d).transpose(1, 2)
    q_abs = fills.long()[:, None] - s + torch.arange(s, device=q.device)
    keep = (torch.arange(k.shape[2], device=q.device)[None, None, :]
            <= q_abs[:, :, None])[:, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=keep,
                                          enable_gqa=hkv != h)


def _paged_bound(q, kp, table, fills):
    """K1's bound at these inputs: each slot's live K/V bytes of every
    KV head read once (the fill capped at the table's pages; int8 pages
    with their f32 scales), q read and the output written once, against
    4 operations per (query row, key it sees, head_dim element) over the
    peak for the query's type."""
    b, s, h, d = q.shape
    hkv = kp.shape[2]
    cap = table.shape[1] * kp.shape[1]
    per_token = 2 * hkv * (d * kp.element_size()
                           + (4 if kp.element_size() == 1 else 0))
    nbytes = 2 * q.numel() * q.element_size()
    ops = 0
    for fill in fills.tolist():
        live = max(0, min(fill, cap))
        nbytes += live * per_token
        ops += 4 * h * d * sum(max(0, min(fill - s + i + 1, live))
                               for i in range(s))
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


# -- phase 4: the main path ---------------------------------------------------


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


def run_main_path(torch, dev, counters, cfg):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import init_params
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
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
        for mod, attr in counters.values():  # count only the traffic below
            setattr(mod, attr, 0)
        for variant in pa.variant_launches:
            pa.variant_launches[variant] = 0
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
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        variants = dict(pa.variant_launches)
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
    log(f"  kernel launches on the main path: {launches}; K1 by variant "
        f"{variants}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(variants["decode"] > 0, "the decode steps did not launch K1's "
          "decode variant")
    shutil.rmtree(bundle, ignore_errors=True)
    return launches, variants, server.model


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


# -- phase 5: parity on the card ----------------------------------------------


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


def check_paged_piece(torch, dev, full_model):
    """Two 256-token pieces of chunked prefill (the JAX bench's chip
    piece, ``bench.py:1199``) through the full-width paged model's
    ``_paged_decode_attend`` on 4 slots at ragged offsets, with the
    kernels (K1's chunk variant on 256 query rows a head: two 128-row
    blocks) against ``use_kernels=False`` on its own cache, as phase 5's
    prefill logits."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM, PagedKV
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    cfg = full_model.cfg
    plain = CausalLM(cfg, use_kernels=False).to(dev).eval()
    plain.load_state_dict(full_model.state_dict())
    b, piece, starts = 4, 256, (0, 37, 64, 200)
    caches = [PagedKV(cfg, b, dev) for _ in range(2)]
    per_slot = cfg.max_pages_per_slot
    for kv in caches:  # slot i owns pages [i * 16, i * 16 + 16)
        kv.block_table.copy_(torch.arange(b * per_slot, dtype=torch.int32,
                                          device=dev).reshape(b, per_slot))
    ids = torch.randint(0, cfg.vocab_size, (b, 2 * piece),
                        generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
    start = torch.tensor(starts, device=dev)[:, None]
    launches = pa.launches
    chunks = pa.variant_launches["chunk"]
    for i in range(2):
        pos = start + i * piece + torch.arange(piece, device=dev)[None]
        chunk = ids[:, i * piece:(i + 1) * piece]
        with torch.inference_mode():
            out = full_model(chunk, positions=pos, cache=caches[0])
            ref = plain(chunk, positions=pos, cache=caches[1])
        diff = (out - ref).abs()
        rel = float(diff.norm() / ref.norm())
        max_abs = float(diff.max())
        log(f"  paged piece {i + 1}: {b} slots x {piece} tokens at "
            f"positions {[int(v) for v in pos[:, 0]]}.., logits "
            f"{list(out.shape)}, kernels vs plain: max_abs {max_abs:.4f} "
            f"(tolerance 0.25), relative L2 {rel:.2e} (tolerance 2e-2)")
        check(bool(torch.isfinite(out).all()), "non-finite paged logits")
        check(max_abs <= 0.25 and rel <= 2e-2, "a 256-token paged piece "
              "through the kernels disagrees with plain")
    launched = pa.launches - launches
    chunked = pa.variant_launches["chunk"] - chunks
    check(launched == chunked == 2 * cfg.num_layers,
          f"K1 launched {launched} times ({chunked} on its chunk variant) "
          f"for 2 pieces x {cfg.num_layers} layers")
    kp = caches[0].pages(0)[0]
    plan = pa.paged_plan(b, piece, cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                         cfg.kv_page_size, per_slot, cfg.dtype, kp.dtype)
    log(f"  K1 launched {launched} times, all on its chunk variant (S = "
        f"{piece}: {plan})")
    # K1 alone on one layer of the pieces' own cache: the second piece's
    # positions, a seeded query, against its plain version at phase 3's
    # tolerance (the logits above also carry the other kernels' rounding)
    kv = caches[0]
    kp, vp, ks, vs = kv.pages(cfg.num_layers - 1)
    fills = (start[:, 0] + 2 * piece).to(torch.int32)
    q = torch.randn(b, piece, cfg.num_heads, cfg.head_dim,
                    generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev).to(cfg.dtype)
    with torch.inference_mode():
        out = pa.paged_attention_chunk(q, kp, vp, kv.block_table, fills,
                                       ks, vs)
        ref = pa.paged_attention_chunk_plain(q, kp, vp, kv.block_table,
                                             fills, ks, vs)
    compare(out, ref, str(cfg.dtype).split(".")[-1],
            f"paged piece: K1 on layer {cfg.num_layers - 1}'s cache, "
            f"S = {piece}, fills {[int(v) for v in fills]}")


# -- phase 4c: chunked prefill on the serving main path ------------------------

# The JAX bench's chunked-prefill configuration at full width
# (bench.py:1196-1199): GPT-small at 2048 positions, 8 slots, chunk 16,
# 64-token pages (a pool of 8 x 32), pieces of 256 under a 384-token
# step budget; 32 requests, every 4th with a 1024-token prompt and the
# rest 64, 64 new tokens each.
CB = dict(slots=8, chunk=16, page=64, prefill_chunk=256, budget=384,
          requests=32, short=64, long=1024, new=64)


def _cb_prompts(vocab: int):
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, CB["long"] if i % 4 == 3 else CB["short"]
                         ).astype(np.int32) for i in range(CB["requests"])]


def _drive_engine(torch, eng, prompts):
    """Submit every prompt at t0 and step to the end; returns ``(tokens
    by request, first-token seconds by request, [per request: the gaps
    between deliveries in ms], wall seconds, [per step: (ms, prefill
    pieces, decode steps)])``. A step ends in a device-to-host copy, so
    its end is when its tokens are delivered."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=CB["new"]) for p in prompts]
    reqs = {r.rid: r for r in eng._queue}
    seen = {rid: 0 for rid in rids}
    stamps = {rid: [] for rid in rids}
    steps = []
    while eng.busy:
        pieces, decode = eng._n_prefill_chunks, eng._n_dispatched_steps
        t_step = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        steps.append(((now - t_step) * 1e3, eng._n_prefill_chunks - pieces,
                      eng._n_dispatched_steps - decode))
        for rid, req in reqs.items():
            if len(req.tokens) > seen[rid]:
                seen[rid] = len(req.tokens)
                stamps[rid].append(now)
    wall = time.perf_counter() - t0
    tokens = [list(reqs[r].tokens) for r in rids]
    ttft = [stamps[r][0] - t0 for r in rids]
    gaps = [[(b - a) * 1e3 for a, b in zip(stamps[r], stamps[r][1:])]
            for r in rids]
    return tokens, ttft, gaps, wall, steps


def _top2_margin(torch, model, ids) -> float:
    """The top-2 logit margin of ``model``'s next-token logits after
    ``ids`` (a full causal forward)."""
    with torch.inference_mode():
        logits = model(torch.tensor([ids], device=model.device))[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def run_chunked_serving(torch, dev, counters):
    """Phase 4c: the same 32 arrivals through the unchunked engine and
    the chunked one (``prefill_chunk`` 256, ``step_token_budget`` 384) on
    a full-width GPT-small bundle (2048 positions, bf16, int8 export),
    after a warm-up of both, in turns (unchunked, chunked, chunked,
    unchunked). Gates: every request gets its 64 tokens,
    every kernel of the serving path launches during the chunked run,
    and every piece's K1 calls take the chunk variant (one a layer a
    piece); then an f32 run of the same arrivals at the full width cut to
    2 layers must give the unchunked engine's tokens exactly (on a
    mismatch the first divergent step's top-2 logit margin is printed).
    Prints time to first token and the largest gap between tokens of the
    short requests, new tokens a second and the engine's step times,
    chunked against unchunked. Returns the chunked run's launches and K1
    launches by variant."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.export import (export_serving_bundle,
                                                       load_serving_bundle)

    cfg = CausalLMConfig(max_seq_len=2048, kv_page_size=CB["page"],
                         kv_num_pages=CB["slots"] * 2048 // CB["page"])
    bundle = PORT_PKG / "_build" / "chip_smoke_cb_bundle"
    export_serving_bundle(cfg, init_params(cfg, seed=0), str(bundle),
                          quantize=True)
    model = load_serving_bundle(str(bundle), dev)[0]
    shutil.rmtree(bundle, ignore_errors=True)
    prompts = _cb_prompts(cfg.vocab_size)
    chunked_kw = dict(prefill_chunk=CB["prefill_chunk"],
                      step_token_budget=CB["budget"])

    def engine(m, chunked):
        return ContinuousEngine(m, num_slots=CB["slots"], chunk=CB["chunk"],
                                **(chunked_kw if chunked else {}))

    for chunked in (False, True):  # warm-up: both engines' shapes
        warm = engine(model, chunked)
        for p in (prompts[0], prompts[1], prompts[3]):
            warm.submit(p, max_new_tokens=2)
        list(warm.run_until_drained())
    # the two engines in turns (unchunked, chunked, chunked, unchunked):
    # host wall clocks drift by tens of percent within a call, so each
    # engine's numbers are the mean of its two runs; the counters count
    # the first chunked run
    results = {False: [], True: []}
    launches = variants = None
    for run, chunked in enumerate((False, True, True, False)):
        eng = engine(model, chunked)
        counted = chunked and launches is None
        if counted:
            torch.cuda.synchronize()
            for mod, attr in counters.values():
                setattr(mod, attr, 0)
            for variant in pa.variant_launches:
                pa.variant_launches[variant] = 0
        tokens, ttft, gaps, wall, steps = _drive_engine(torch, eng, prompts)
        if counted:
            torch.cuda.synchronize()
            launches = {name: getattr(mod, attr)
                        for name, (mod, attr) in counters.items()}
            variants = dict(pa.variant_launches)
        check(all(len(t) == CB["new"] for t in tokens),
              f"{'chunked' if chunked else 'unchunked'} engine: a request "
              "did not get its 64 tokens")
        short = [i for i, p in enumerate(prompts) if len(p) == CB["short"]]
        r = dict(wall_s=wall, tokens_per_s=sum(map(len, tokens)) / wall,
                 ttft_ms=statistics.median(ttft[i] * 1e3 for i in short),
                 ttft_max_ms=max(ttft[i] * 1e3 for i in short),
                 max_gap_ms=max(max(gaps[i]) for i in short),
                 pieces=eng.stats["prefill_chunks"],
                 decode_steps=eng.stats["dispatched_steps"])
        results[chunked].append(r)
        ms = [st[0] for st in steps]
        with_piece = [st[0] for st in steps if st[1]]
        slow = max(steps)
        log(f"  run {run + 1}, {'chunked  ' if chunked else 'unchunked'}: "
            f"{CB['requests'] * CB['new']} new tokens in {wall:.3f} s = "
            f"{r['tokens_per_s']:.1f} tokens/s; short requests' time to "
            f"first token median {r['ttft_ms']:.1f} ms, max "
            f"{r['ttft_max_ms']:.1f} ms; largest gap between tokens "
            f"{r['max_gap_ms']:.1f} ms; prefill pieces {r['pieces']}, "
            f"decode steps {r['decode_steps']}; {len(ms)} engine steps, "
            f"median {statistics.median(ms):.1f} ms, {len(with_piece)} with "
            f"a piece (median "
            f"{statistics.median(with_piece) if with_piece else 0:.1f} ms), "
            f"slowest {slow[0]:.1f} ms ({slow[1]} pieces, {slow[2]} decode "
            "steps)")
    mean = {c: {key: statistics.mean(r[key] for r in rs) for key in
                ("tokens_per_s", "ttft_ms", "max_gap_ms")}
            for c, rs in results.items()}
    log(f"  chunked / unchunked, means of two runs each: tokens/s "
        f"{mean[True]['tokens_per_s'] / mean[False]['tokens_per_s']:.3f}, "
        f"median TTFT {mean[True]['ttft_ms'] / mean[False]['ttft_ms']:.3f}, "
        f"largest gap "
        f"{mean[True]['max_gap_ms'] / mean[False]['max_gap_ms']:.3f}")
    pieces = results[True][0]["pieces"]
    log(f"  chunked run's launches {launches}; K1 by variant {variants}")
    n_long = sum(len(p) == CB["long"] for p in prompts)
    check(pieces == n_long * CB["long"] // CB["prefill_chunk"],
          f"{pieces} prefill pieces for {n_long} long prompts of "
          f"{CB['long'] // CB['prefill_chunk']}")
    check(variants["chunk"] == pieces * cfg.num_layers,
          f"K1's chunk variant launched {variants['chunk']} times for "
          f"{pieces} pieces x {cfg.num_layers} layers")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the chunked path")

    # f32 (the full width, 2 layers): chunked == unchunked, token for token
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    with torch.device(dev):
        m32 = CausalLM(cfg32)
    m32.load_params(init_params(cfg32, seed=1)).eval()
    outs = {chunked: _drive_engine(torch, engine(m32, chunked), prompts)[0]
            for chunked in (False, True)}
    for i, (a, b) in enumerate(zip(outs[True], outs[False])):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            margin = _top2_margin(torch, m32, list(prompts[i]) + b[:j])
            raise SmokeFailure(
                f"f32 chunked engine diverges from the unchunked one at "
                f"request {i} (prompt {len(prompts[i])}), new token {j}: "
                f"{a[j]} != {b[j]}; top-2 logit margin there {margin:.3e}")
    log(f"  f32 2-layer chunked engine == unchunked engine for all "
        f"{len(prompts)} requests ({CB['new']} tokens each)")
    del model, m32
    return launches, variants


# -- phase 6: the training main path ------------------------------------------

CORPUS_WORDS = ("flash", "attention", "kernel", "hopper", "gradient",
                "layer", "norm", "token", "train", "step", "batch", "loss",
                "adam", "warp", "shared", "memory", "the", "a", "of", "and")


def write_corpus(root: Path, docs: int = 1200, seed: int = 0) -> str:
    """A seeded synthetic corpus: sentences of words from a fixed list,
    blank-line-separated documents of 60-120 words (~600 KB, ~1100 rows
    of 512 bytes: past lm_pretrain's 256-row shuffle buffer)."""
    rng = random.Random(seed)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(4):
        parts = []
        for _ in range(docs // 4):
            words = [rng.choice(CORPUS_WORDS)
                     for _ in range(rng.randint(60, 120))]
            parts.append(" ".join(words) + ".")
        (root / f"part-{f}.txt").write_text("\n\n".join(parts) + "\n")
    return str(root / "*.txt")


TRAIN_FLAGS = ["--seq-len", "512", "--batch-size", "16",
               "--compute-dtype", "bfloat16", "--learning-rate", "3e-4",
               "--epochs", "2", "--steps-per-epoch", "10", "--seed", "0"]


def run_training(torch, dev, counters):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import generate
    from pyspark_tf_gke_tpu_torch.train.export import load_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main as lm_main

    work = PORT_PKG / "_build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    pattern = write_corpus(work / "corpus")
    bundle = work / "bundle"
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    history = lm_main(["--data-pattern", pattern, *TRAIN_FLAGS,
                       "--output-dir", str(work / "run"),
                       "--export-bundle", str(bundle), "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    losses = history["loss"]
    log(f"  lm_pretrain 2 epochs x 10 steps in {wall:.1f} s (model init, "
        f"data, training, checkpoint and int8 export)")
    for key in ("loss", "next_token_accuracy", "step_time_ms",
                "examples_per_sec"):
        log(f"  {key}: {history[key]}")
    tokens_s = [e * 512 for e in history["examples_per_sec"]]
    log(f"  tokens/s: {tokens_s}")
    log(f"  kernel launches on the training path (20 steps): {launches}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"epoch-2 mean loss {losses[1]} is not "
          f"below epoch 1's {losses[0]}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the training path")
    model, _, meta = load_serving_bundle(str(bundle), device=str(dev))
    out = generate(model, [list(b"the flash kernel ")], 16)
    text = bytes(t for t in out[0].tolist() if t < 256).decode(
        "utf-8", "replace")
    check(out.shape == (1, 33) and out.device.type == "cuda",
          f"generate from the exported bundle gave {tuple(out.shape)}")
    log(f"  exported bundle ({'int8' if meta['quantized'] else 'dense'}) "
        f"generates on the card: {text!r}")
    shutil.rmtree(work, ignore_errors=True)
    return launches, history


def _train_model(torch, dev, cfg, seed, use_kernels=True):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLM, init_params

    with torch.device(dev):
        model = CausalLM(cfg, use_kernels=use_kernels,
                         param_dtype=torch.float32)
    return model.load_params(init_params(cfg, seed=seed))


def _lm_batch(torch, dev, cfg, b, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"input_ids": torch.randint(0, cfg.vocab_size,
                                       (b, cfg.max_seq_len), generator=g,
                                       device=dev, dtype=torch.int32)}


def profile_training(torch, dev):
    """Two steady full-width training steps under ``torch.profiler``:
    host wall against device-busy time, and the top device ops."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512)
    trainer = Trainer(_train_model(torch, dev, cfg, 0),
                      TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    batch = _lm_batch(torch, dev, cfg, 16, 7)
    for _ in range(3):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"  5 steady steps without the profiler: {step_ms:.2f} ms/step, "
        f"{16 * 512 / step_ms * 1e3:.0f} tokens/s")
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    if busy <= 0:
        log(f"  2 steps: wall {wall:.2f} ms; device time not visible to "
            "torch.profiler")
        return
    log(f"  2 steps under the profiler: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, ms in top[:10]:
        log(f"    {ms:9.3f} ms  {name[:90]}")


# -- phase 7: training parity on the card -------------------------------------


def _grads(torch, model, batch):
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    task = TASKS["causal_lm"]()
    loss, _ = task.loss_and_metrics(task.forward(model, batch), batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _grad_diff(torch, got, want):
    """Relative L2 error of the whole gradient tree, and the tensor with
    the largest error relative to max(its norm, 1e-3 x the largest
    tensor norm): some gradients are zero up to rounding (a key bias
    shifts every score of a row equally), and their relative error is
    noise."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
    den = sum(float((want[n] ** 2).sum()) for n in want)
    floor = 1e-3 * max(float(w.norm()) for w in want.values())
    rels = {n: float((got[n] - want[n]).norm()) / max(float(want[n].norm()),
                                                      floor, 1e-30)
            for n in want}
    worst = max(rels, key=rels.get)
    return math.sqrt(num / max(den, 1e-30)), worst, rels[worst]


def check_training_parity(torch, dev):
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    # f32, 2 layers at the full width: kernels against use_kernels=False
    # from one init. Both compute every product in f32 (TF32 is off), so
    # they differ by summation order: step-0 gradients within 1e-4
    # relative L2 (the whole tree, and each tensor on its own) and losses
    # within 1e-4 over 3 Adam steps.
    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512, num_layers=2,
                         dtype=torch.float32)
    batches = [_lm_batch(torch, dev, cfg, 8, 10 + i) for i in range(3)]
    runs = {}
    for use_kernels in (True, False):
        model = _train_model(torch, dev, cfg, 3, use_kernels)
        _, g0 = _grads(torch, model, batches[0])
        trainer = Trainer(model, TASKS["causal_lm"](),
                          tx=make_optimizer(3e-4))
        state = trainer.init_state()
        losses = [float(trainer.step(state, b)[1]["loss"]) for b in batches]
        runs[use_kernels] = (g0, losses)
    rel, worst, worst_rel = _grad_diff(torch, runs[True][0], runs[False][0])
    dloss = max(abs(a - b) for a, b in zip(runs[True][1], runs[False][1]))
    log(f"  f32 2-layer: losses kernels {runs[True][1]} vs plain "
        f"{runs[False][1]} (max diff {dloss:.2e}, tolerance 1e-4); step-0 "
        f"gradients relative L2 {rel:.2e}, worst tensor {worst} "
        f"{worst_rel:.2e} (tolerance 1e-4 each)")
    check(dloss <= 1e-4 and rel <= 1e-4 and worst_rel <= 1e-4,
          "f32 training through the kernels disagrees with plain")

    # bf16 at full width: the kernels round P and dS to bf16 where the
    # TPU kernels do and keep the LayerNorm statistics in f32, rounding
    # each output once, while the plain path's autograd
    # rounds the probabilities and every intermediate product to bf16
    # (as its forward does: 2e-2 on the prefill logits); through 12 layers of
    # backward allow 5e-2 relative L2 over the whole gradient tree. The
    # tree's norm is dominated by the embedding, head and MLP, so each
    # tensor is held on its own too: the worst read 1.96e-2 on an H100
    # (layer 11's key kernel), allow 1e-1 — a wrong attention or
    # LayerNorm gradient in any layer is off by O(1). The step-0 loss (an
    # f32 mean over 8192 tokens of bf16 logits) read 3e-5 apart: allow
    # 1e-3.
    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512)
    batch = _lm_batch(torch, dev, cfg, 16, 20)
    loss_k, gk = _grads(torch, _train_model(torch, dev, cfg, 4), batch)
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 4, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  full-width bf16 step-0: loss kernels {loss_k:.5f} vs plain "
        f"{loss_p:.5f} (diff {abs(loss_k - loss_p):.2e}, tolerance 1e-3); "
        f"gradients relative L2 {rel:.2e} (tolerance 5e-2); worst tensor "
        f"{worst} {worst_rel:.2e} (tolerance 1e-1)")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          "non-finite bf16 gradient")
    check(abs(loss_k - loss_p) <= 1e-3,
          "bf16 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "bf16 gradients through the kernels disagree")


def check_wide_lm_step(torch, dev, counters):
    """GPT-2 large's widths (hidden 1280, 20 heads of 64, FFN 5120; the
    JAX package trains them with ``lm_pretrain --hidden-size 1280
    --num-heads 20``), 2 layers, bf16, batch 4 x 128: step-0 loss and
    gradients through the kernels (K3 and K3b at D = 1280) against
    ``use_kernels=False`` from one init under phase 7's bf16 limits, then
    one Adam step through the ``Trainer``. Every LayerNorm counter must
    move. Returns the launches."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=128, hidden_size=1280,
                         num_layers=2, num_heads=20, intermediate_size=5120)
    batch = _lm_batch(torch, dev, cfg, 4, 30)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    model = _train_model(torch, dev, cfg, 5)
    loss_k, gk = _grads(torch, model, batch)
    trainer = Trainer(model, TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    step_loss = float(trainer.step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 5, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  hidden 1280, 20 heads, 2 layers, bf16, 4 x 128: loss kernels "
        f"{loss_k:.5f} vs plain {loss_p:.5f} (diff {abs(loss_k - loss_p):.2e}"
        f", tolerance 1e-3); gradients relative L2 {rel:.2e} (tolerance "
        f"5e-2); worst tensor {worst} {worst_rel:.2e} (tolerance 1e-1); "
        f"Adam step loss {step_loss:.5f}; launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values())
          and math.isfinite(step_loss), "non-finite hidden-1280 step")
    check(abs(loss_k - loss_p) <= 1e-3,
          "hidden-1280 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "hidden-1280 gradients through the kernels disagree")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched at hidden 1280")
    return launches


def check_d128_lm(torch, dev, counters):
    """Phase 7c: a Llama-width head (``lm_pretrain --hidden-size 1024
    --num-heads 8``: 8 heads of 128, FFN 4096; depth cut to 2 layers,
    bf16, batch 4 x 512): step-0 loss and gradients through the kernels
    (K2f, K2dq and K2dkv on the tensor cores at D 128) against
    ``use_kernels=False`` from one init under phase 7's bf16 limits, then
    one Adam step; every training kernel's counter must move. Then a
    paged bundle of the same widths is served over HTTP (4 slots) for
    three greedy requests: prefill through K2f at D 128, decode through
    K1's first design at D 128; and an f32 copy's engine must give the
    dense ``generate``'s tokens. Returns ``(training launches, serving
    launches)``."""
    from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                           CausalLMConfig,
                                                           generate,
                                                           init_params)
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa
    from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
    from pyspark_tf_gke_tpu_torch.train.export import export_serving_bundle
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                      start_http_server)
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    cfg = CausalLMConfig(vocab_size=259, max_seq_len=512, hidden_size=1024,
                         num_layers=2, num_heads=8, intermediate_size=4096)
    check(cfg.head_dim == 128
          and fa.flash_plan(cfg.head_dim, cfg.dtype).design == "wgmma",
          "the phase-7c model does not run the D-128 tensor-core kernels")
    batch = _lm_batch(torch, dev, cfg, 4, 40)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    model = _train_model(torch, dev, cfg, 6)
    loss_k, gk = _grads(torch, model, batch)
    trainer = Trainer(model, TASKS["causal_lm"](), tx=make_optimizer(3e-4))
    state = trainer.init_state()
    step_loss = float(trainer.step(state, batch)[1]["loss"])
    torch.cuda.synchronize()
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    loss_p, gp = _grads(torch, _train_model(torch, dev, cfg, 6, False), batch)
    rel, worst, worst_rel = _grad_diff(torch, gk, gp)
    log(f"  hidden 1024, 8 heads of 128, 2 layers, bf16, 4 x 512: loss "
        f"kernels {loss_k:.5f} vs plain {loss_p:.5f} (diff "
        f"{abs(loss_k - loss_p):.2e}, tolerance 1e-3); gradients relative "
        f"L2 {rel:.2e} (tolerance 5e-2); worst tensor {worst} "
        f"{worst_rel:.2e} (tolerance 1e-1); Adam step loss "
        f"{step_loss:.5f}; launches {launches}")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values())
          and math.isfinite(step_loss), "non-finite D-128 step")
    check(abs(loss_k - loss_p) <= 1e-3,
          "D-128 loss through the kernels disagrees")
    check(rel <= 5e-2 and worst_rel <= 1e-1,
          "D-128 gradients through the kernels disagree")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched at head_dim 128")
    del model, trainer, state, gk, gp

    serve_cfg = dataclasses.replace(cfg, kv_page_size=64, kv_num_pages=32)
    bundle = PORT_PKG / "_build" / "chip_smoke_d128_bundle"
    export_serving_bundle(serve_cfg, init_params(serve_cfg, seed=2),
                          str(bundle), quantize=True)
    server = BundleServer(str(bundle), device=str(dev), continuous_slots=4,
                          continuous_chunk=8)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = random.Random(3)
    serve_counters = {"layernorm": (ln, "launches"),
                      "flash_attention_fwd": (fa, "launches"),
                      "paged_attention": (pa, "launches")}
    try:
        _post(url + "/v1/generate", {"prompt": "warm up", "max_new_tokens": 2})
        torch.cuda.synchronize()
        for mod, attr in serve_counters.values():
            setattr(mod, attr, 0)
        rows0 = pa.variant_launches["rows"]
        body = {"prompts": [_prompt(rng, n) for n in (30, 150, 400)],
                "max_new_tokens": 24}
        res = _post(url + "/v1/generate", body)
        torch.cuda.synchronize()
        served = {name: getattr(mod, attr)
                  for name, (mod, attr) in serve_counters.items()}
        rows = pa.variant_launches["rows"] - rows0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.shutdown()
        thread.join(30)
        shutil.rmtree(bundle, ignore_errors=True)
    check(res[0] == 200 and len(res[1]["completions"]) == 3,
          f"D-128 generate failed: {res}")
    for prompt, comp in zip(body["prompts"], res[1]["completions"]):
        check(comp["completion"].startswith(prompt)
              and 0 <= comp["new_tokens"] <= 24,
              f"malformed D-128 completion {comp}")
    log(f"  D-128 bundle served 3 greedy requests: new tokens "
        f"{[c['new_tokens'] for c in res[1]['completions']]}; launches "
        f"{served}, K1 first design {rows}")
    for name, n in served.items():
        check(n > 0, f"kernel {name} was not launched serving head_dim 128")
    check(rows == served["paged_attention"],
          "K1 at head_dim 128 did not run its first design")

    cfg32 = dataclasses.replace(serve_cfg, dtype=torch.float32)
    with torch.device(dev):
        m32 = CausalLM(cfg32)
    m32.load_params(init_params(cfg32, seed=2)).eval()
    prompts = [[rng.randrange(256) for _ in range(n)] for n in (20, 100, 300)]
    eng = ContinuousEngine(m32, num_slots=4, chunk=8)
    rids = {eng.submit(p, max_new_tokens=16): p for p in prompts}
    got = dict(eng.run_until_drained())
    for rid, p in rids.items():
        ref = generate(m32, [p], 16)[0, len(p):].tolist()
        check(got[rid] == ref, f"D-128 f32 engine tokens {got[rid]} != "
              f"generate {ref} (prompt {len(p)} tokens)")
    log("  D-128 f32 engine greedy tokens == dense generate for 3 prompts "
        "(16 tokens each)")
    return launches, served


# -- phases 8 and 9: ResNet-50 training ---------------------------------------

RESNET_BATCH, RESNET_IMAGE, RESNET_STEPS = 64, 224, (2, 10)


def resnet_batch(b: int, size: int, seed: int = 0):
    """Images ``default_rng(seed).uniform(0, 1)`` as f32 NHWC, labels in
    [0, 1000)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, size=(b, size, size, 3)
                                 ).astype(np.float32),
            "label": rng.integers(0, 1000, size=b).astype(np.int32)}


# launches of each ResNet kernel per training step of ResNet-50, by
# variant: K4 on the 36 1x1 convs, K5 on the 13 stride-1 3x3 convs of
# fused3 (none in fused, whose 3x3 convs are cuDNN's)
RESNET_K4 = ("fused_matmul_fwd", "fused_matmul_dx", "fused_matmul_dw")
RESNET_K5 = ("fused_conv3_fwd", "fused_conv3_dx", "fused_conv3_dw")
RESNET_PER_STEP = {
    "fused": {**{k: 36 for k in RESNET_K4}, **{k: 0 for k in RESNET_K5}},
    "fused3": {**{k: 36 for k in RESNET_K4}, **{k: 13 for k in RESNET_K5}},
}


def run_resnet_training(torch, dev, counters, variant):
    """ResNet-50 ``variant`` (bf16, f32 master weights and statistics)
    through ``Trainer.fit``: 2 epochs x 10 steps on one repeated batch of
    64 images at 224^2, Adam 1e-3; then one ``evaluate`` with
    ``train=False``, which must launch only the forward kernels (once per
    call site) and leave the statistics as they were."""
    import itertools

    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    per_step = RESNET_PER_STEP[variant]
    t0 = time.perf_counter()
    model = ResNet50(norm_variant=variant, device=dev, seed=0)
    trainer = Trainer(model, TASKS["resnet"](), learning_rate=1e-3)
    state = trainer.init_state()
    init_stats = {k: v.clone() for k, v in state.batch_stats.items()}
    batch = resnet_batch(RESNET_BATCH, RESNET_IMAGE)
    log(f"  model ({sum(p.numel() for p in model.parameters())} parameters, "
        f"{len(init_stats)} statistics buffers) and batch ready in "
        f"{time.perf_counter() - t0:.1f} s")
    epochs, steps = RESNET_STEPS
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    state, history = trainer.fit(state, itertools.repeat(batch), epochs,
                                 steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in counters.items()}
    log(f"  Trainer.fit {epochs} epochs x {steps} steps in {wall:.1f} s")
    for key in ("loss", "accuracy", "step_time_ms", "examples_per_sec"):
        log(f"  {key}: {history[key]}")
    log(f"  kernel launches on the ResNet {variant} path ({epochs * steps} "
        f"steps): {launches}")
    losses = history["loss"]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[1] < losses[0], f"epoch-2 mean loss {losses[1]} is not "
          f"below epoch 1's {losses[0]}")
    for name, n in launches.items():
        check(n == per_step[name] * epochs * steps, f"kernel {name} "
              f"launched {n} times, not {per_step[name]} per step")
    moved = [k for k, v in state.batch_stats.items()
             if not torch.equal(v, init_stats[k])]
    check(len(moved) == len(init_stats), f"{len(init_stats) - len(moved)} "
          "running statistics never left their init")
    # eval: the running statistics, the forward kernels without
    # statistics, no backward
    dev_batch = put_batch(batch, dev)
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    metrics = trainer.evaluate(state, [dev_batch])
    torch.cuda.synchronize()
    eval_launches = {name: getattr(mod, attr)
                     for name, (mod, attr) in counters.items()}
    log(f"  evaluate (train=False): {metrics}; launches {eval_launches}")
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite eval metrics {metrics}")
    check(eval_launches == {k: n if k.endswith("_fwd") else 0
                            for k, n in per_step.items()},
          f"evaluate launched {eval_launches}")
    check(all(torch.equal(v, before[k])
              for k, v in state.batch_stats.items()),
          "evaluate changed the running statistics")
    return launches, trainer, state, dev_batch


def time_resnet(torch, trainer, state, batch, label, profile=True):
    """ms/step of ``trainer`` over 5 steady steps without the profiler;
    with ``profile``, two more steps under ``torch.profiler`` (device busy
    and idle share, top device ops)."""
    for _ in range(2):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    b = RESNET_BATCH
    log(f"  {label}: {ms:.2f} ms/step, {b / ms * 1e3:.1f} images/s (5 steady "
        "steps, no profiler)")
    if not profile:
        return ms
    wall, busy, top = _profiled(
        torch, lambda: [trainer.step(state, batch) for _ in range(2)])
    if busy <= 0:
        log(f"  2 steps: wall {wall:.2f} ms; device time not visible to "
            "torch.profiler")
        return ms
    log(f"  2 {label} steps under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for name, t in top[:12]:
        log(f"    {t:9.3f} ms  {name[:90]}")
    return ms


def time_bn_resnet(torch, dev, batch):
    """The ``bn`` variant's step (cuDNN convs, no port kernel), the
    yardstick of the fused paths."""
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    trainer = Trainer(ResNet50(norm_variant="bn", device=dev, seed=0),
                      TASKS["resnet"](), learning_rate=1e-3)
    ms = time_resnet(torch, trainer, trainer.init_state(), batch,
                     "bn (cuDNN convs, no port kernel)", profile=False)
    del trainer
    torch.cuda.empty_cache()
    return ms


def _nonzero_norm3(torch, model, seed: int):
    """Every norm3 scale to seeded values in [0.1, 0.2): at its zero
    init every residual branch's gradient (K4dx and K4dw inside the
    branches, and the statistics' cotangents) is exactly zero. Larger
    scales make the f32 gradients of this deep, small-batch network
    chaotic: at [0.25, 0.75) a 1e-6 relative change of the input moves
    them by 1e-2 (relative L2) on the CPU; at [0.1, 0.2), by 5e-4."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm3_scale"):
                p.copy_(torch.rand(p.shape, generator=g) * 0.1 + 0.1)


def _resnet_grads(torch, model, batch):
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS

    task = TASKS["resnet"]()
    loss, _ = task.loss_and_metrics(task.forward(model, batch, train=True),
                                    batch)
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


# Kernels against use_kernels=False (the plain versions, which round at
# the kernels' points) on one ResNet-50 training step: |loss diff|,
# whole-tree and worst-tensor gradient relative L2, and the running
# statistics' max abs difference (f32). Every K4 / K5 call agrees with
# its plain version on the same inputs to ~1e-6 (f32) — held below as
# CALL_REL_L2 — but the network amplifies rounding-level changes into
# the gradients: on an H100 the plain versions on the card against the
# same plain versions on the host's CPU read 1.0e-2 (f32, fused), as far
# apart as the kernels are, and the "noise" reading printed beside (the
# plain versions against themselves with the input scaled by 1 + 1e-6)
# reads 1.7e-3 (f32) and 1.0e-1 (bf16; worst tensor bn_init.bias 0.42,
# whose gradient is zero up to rounding). Limits: the H100 readings
# (PERF.md, ResNet-50 parity) with a margin of 2-10x; fused3's f32 loss
# read 0 and takes 10x fused's 4.8e-7.
RESNET_PARITY_LIMITS = {
    ("fused", "float32"): dict(loss=1e-5, rel=3e-2, worst=5e-2, stats=1e-5),
    ("fused", "bfloat16"): dict(loss=2e-3, rel=2e-1, worst=6e-1, stats=None),
    ("fused3", "float32"): dict(loss=5e-6, rel=3e-2, worst=5e-2, stats=3e-6),
    ("fused3", "bfloat16"): dict(loss=1e-3, rel=2e-1, worst=7.5e-1,
                                 stats=None),
}
# each K4 and K5 call of the kernels' step against its plain version on
# the same inputs, relative L2 of every output: f32 sums in another order
# (K4 read <= 1.2e-6); bf16 outputs one rounding apart where the f32
# sums straddle a rounding point (K4 read <= 8.9e-5)
CALL_REL_L2 = {"float32": 1e-5, "bfloat16": 1e-3}


class _CallCheck:
    """While active, every K4 and K5 wrapper call also runs the plain
    version on the same inputs and keeps the worst relative L2 per
    output; ``calls`` counts the kernel calls by op."""

    def __init__(self, torch):
        from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
        from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

        self.torch, self.worst = torch, {}
        self.calls = {"K4": 0, "K5": 0}
        # (op, module, wrapper names, plain versions)
        self.ops = (
            ("K4", fm, ("norm_relu_matmul_fwd", "norm_relu_matmul_dx",
                        "norm_relu_matmul_dw"),
             (fm._fwd_plain, fm.norm_relu_matmul_dx_plain,
              fm.norm_relu_matmul_dw_plain)),
            ("K5", fc, ("conv3_fwd", "conv3_dx", "conv3_dw"),
             (fc.conv3_fwd_plain, fc.conv3_dx_plain, fc.conv3_dw_plain)))
        self.saved = [(mod, names, [getattr(mod, n) for n in names])
                      for _, mod, names, _ in self.ops]

    def _note(self, what, got, want):
        if got is None:
            return
        got, want = got.float(), want.float()
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        if rel >= self.worst.get(what, (-1.0,))[0]:
            self.worst[what] = (rel, tuple(got.shape))

    def _wrap(self, op, kernels, plains):
        fwd, dx, dw = kernels
        pfwd, pdx, pdw = plains

        def check_fwd(x, w, a, b, relu, want_stats):
            y, st = fwd(x, w, a, b, relu, want_stats)
            ry, rst = pfwd(x, w, a, b, relu, want_stats)
            self._note(f"{op}f y", y, ry)
            self._note(f"{op}f stats", st, rst)
            self.calls[op] += 1
            return y, st

        def check_dx(dy, w, x, a, b, relu):
            got, ds = dx(dy, w, x, a, b, relu)
            want, rds = pdx(dy, w, x, a, b, relu)
            self._note(f"{op}dx dx", got, want)
            self._note(f"{op}dx da/db", ds, rds)
            self.calls[op] += 1
            return got, ds

        def check_dw(x, dy, a, b, relu):
            got = dw(x, dy, a, b, relu)
            self._note(f"{op}dw dw", got, pdw(x, dy, a, b, relu))
            self.calls[op] += 1
            return got

        return check_fwd, check_dx, check_dw

    def __enter__(self):
        for (op, mod, names, plains), (_, _, kernels) in zip(self.ops,
                                                             self.saved):
            for name, fn in zip(names, self._wrap(op, kernels, plains)):
                setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, names, kernels in self.saved:
            for name, fn in zip(names, kernels):
                setattr(mod, name, fn)


def check_resnet_parity(torch, dev, variant):
    """One training forward and backward of ResNet-50 ``variant`` through
    the kernels against ``use_kernels=False`` from one init with every
    norm3 scale non-zero: f32 (TF32 off) at full depth on 8 images of
    64^2 — step-0 loss, gradients and the running statistics after the
    step; bf16 on the full path (64 images of 224^2) — step-0 loss and
    gradients. During the kernels' step every K4 and K5 call is held
    against its plain version on the same inputs."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50

    per_step = RESNET_PER_STEP[variant]
    want_calls = {"K4": 3 * per_step[RESNET_K4[0]],
                  "K5": 3 * per_step[RESNET_K5[0]]}
    results = {}
    for dtype, b, size in ((torch.float32, 8, 64),
                           (torch.bfloat16, RESNET_BATCH, RESNET_IMAGE)):
        name = str(dtype).split(".")[-1]
        batch = put_batch(resnet_batch(b, size, seed=1), dev)
        nudged = dict(batch, image=batch["image"] * (1.0 + 1e-6))
        runs = {}
        for key, use_kernels, inputs in (("kernels", True, batch),
                                         ("plain", False, batch),
                                         ("noise", False, nudged)):
            model = ResNet50(norm_variant=variant, dtype=dtype, device=dev,
                             seed=3, use_kernels=use_kernels)
            _nonzero_norm3(torch, model, 4)
            if use_kernels:
                with _CallCheck(torch) as calls:
                    loss, grads = _resnet_grads(torch, model, inputs)
            else:
                loss, grads = _resnet_grads(torch, model, inputs)
            stats = {k: v.clone() for k, v in model.named_buffers()}
            runs[key] = (loss, grads, stats)
            del model
        worst_call = max(rel for rel, _ in calls.worst.values())
        log(f"  {variant} {name} B={b} {size}^2: {calls.calls} kernel calls "
            "each held against its plain version on the same inputs, worst "
            "relative L2 per output: " + ", ".join(
                f"{what} {rel:.2e} {list(shape)}"
                for what, (rel, shape) in calls.worst.items())
            + f" (limit {CALL_REL_L2[name]:g})")
        check(calls.calls == want_calls and worst_call <= CALL_REL_L2[name],
              f"{variant} {name}: a kernel call of the training step "
              "disagrees with its plain version")
        (lk, gk, sk), (lp, gp, sp) = runs["kernels"], runs["plain"]
        rel, worst, worst_rel = _grad_diff(torch, gk, gp)
        nrel, nworst, nworst_rel = _grad_diff(torch, runs["noise"][1], gp)
        check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
              f"non-finite {variant} {name} gradient")
        stat_err = max(float((sk[k] - sp[k]).abs().max()) for k in sk)
        lim = RESNET_PARITY_LIMITS[variant, name]
        log(f"  {variant} {name} B={b} {size}^2: loss kernels {lk:.6f} vs "
            f"plain {lp:.6f} (diff {abs(lk - lp):.2e}, limit "
            f"{lim['loss']:g}); gradients relative L2 {rel:.2e} (limit "
            f"{lim['rel']:g}), worst tensor {worst} {worst_rel:.2e} (limit "
            f"{lim['worst']:g}); running statistics max abs diff "
            f"{stat_err:.2e} (limit {lim['stats']})")
        log(f"    noise: plain with the input x (1 + 1e-6) vs plain: "
            f"gradients relative L2 {nrel:.2e}, worst tensor {nworst} "
            f"{nworst_rel:.2e}")
        check(abs(lk - lp) <= lim["loss"] and rel <= lim["rel"]
              and worst_rel <= lim["worst"]
              and (lim["stats"] is None or stat_err <= lim["stats"]),
              f"{variant} {name} ResNet-50 training through the kernels "
              "disagrees with the plain versions")
        results[name] = (abs(lk - lp), rel, worst_rel, stat_err)
        torch.cuda.empty_cache()
    return results


# -- phase 12: the other ResNet variants -------------------------------------

# (norm_variant, s2d_stem): every variant of models/resnet.py not trained
# above, and the space-to-depth stem under both stem families
RESNET_OTHER_VARIANTS = (("bn_f32", False), ("gn", False), ("none", False),
                         ("nf", False), ("nf", True), ("fused3", True))


def check_resnet_variants(torch, dev, k5_counters):
    """One ``Trainer`` step of ResNet-50 (bf16) for each of
    :data:`RESNET_OTHER_VARIANTS` on 8 images of 64^2: the forward and
    backward give a finite loss and finite gradients, the update finite
    parameters, and ``fused3`` with the s2d stem launches the K5
    kernels."""
    from pyspark_tf_gke_tpu_torch.data.pipeline import put_batch
    from pyspark_tf_gke_tpu_torch.models.resnet import ResNet50
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    batch = put_batch(resnet_batch(8, 64, seed=2), dev)
    for variant, s2d in RESNET_OTHER_VARIANTS:
        tag = f"{variant}{' + s2d_stem' if s2d else ''}"
        model = ResNet50(norm_variant=variant, s2d_stem=s2d, device=dev,
                         seed=5)
        for mod, attr in k5_counters.values():
            setattr(mod, attr, 0)
        loss, grads = _resnet_grads(torch, model, batch)
        torch.cuda.synchronize()
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in k5_counters.items()}
        trainer = Trainer(model, TASKS["resnet"](), learning_rate=1e-3)
        state, metrics = trainer.step(trainer.init_state(), batch)
        step_loss = float(metrics["loss"])
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        params_ok = all(bool(torch.isfinite(p).all())
                        for p in state.params.values())
        gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        log(f"  {tag}: loss {loss:.5f}, {len(grads)} gradients, all finite "
            f"{finite}, norm {gnorm:.4e}; after one Adam step: loss "
            f"{step_loss:.5f}, parameters finite {params_ok}; K5 launches "
            f"{launches}")
        check(math.isfinite(loss) and math.isfinite(step_loss) and finite
              and params_ok and gnorm > 0, f"ResNet-50 {tag}: non-finite "
              "or zero training step")
        if variant == "fused3":
            check(all(n > 0 for n in launches.values()),
                  f"ResNet-50 {tag} did not launch every K5 kernel")
        del model, trainer, state
        torch.cuda.empty_cache()


# -- main ---------------------------------------------------------------------


# the records' keys beyond the contract's that the kernels line carries
EXTRA_KEYS = ("graph_ms", "library_graph_ms", "library_contiguous_ms",
              "library_contiguous_graph_ms", "train_shape", "decode_shape",
              "full_pool", "piece", "d128", "d80", "launches_by_variant",
              "launches_by_variant_chunked")
# kernels (substrings of ptxas's entry names) that must not spill: the
# tensor-core kernels and K1's decode variant and merge
NO_SPILL = ("wgmma", "paged_decode", "paged_merge")
# (name, source, the TPU kernel it replaces, design of its bf16
# instantiation: "wgmma" on the tensor cores, "simt" on the CUDA cores;
# K1 by variant, K2 by head width)
FLASH_DESIGN = ("wgmma (bf16 at head_dim 64, 128), simt "
                "(csrc/flash_attention_simt.cu: other head_dim, f32)")
KERNELS = (
    ("layernorm", "pyspark_tf_gke_tpu_torch/csrc/layernorm.cu",
     "pyspark_tf_gke_tpu/ops/pallas/layernorm.py:37", "simt"),
    ("layernorm_bwd", "pyspark_tf_gke_tpu_torch/csrc/layernorm_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/layernorm.py:98", "simt"),
    ("flash_attention_fwd", "pyspark_tf_gke_tpu_torch/csrc/flash_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:49", FLASH_DESIGN),
    ("flash_attention_dq",
     "pyspark_tf_gke_tpu_torch/csrc/flash_attention_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:162", FLASH_DESIGN),
    ("flash_attention_dkv",
     "pyspark_tf_gke_tpu_torch/csrc/flash_attention_bwd.cu",
     "pyspark_tf_gke_tpu/ops/pallas/flash_attention.py:215", FLASH_DESIGN),
    ("paged_attention", "pyspark_tf_gke_tpu_torch/csrc/paged_attention.cu",
     "pyspark_tf_gke_tpu/ops/pallas/paged_attention.py:124",
     "split-kv simt (decode), wgmma (chunk), rows (other head_dim, f32)"),
    ("fused_matmul_fwd", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:91", "wgmma"),
    ("fused_matmul_dx", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:178", "wgmma"),
    ("fused_matmul_dw", "pyspark_tf_gke_tpu_torch/csrc/fused_matmul.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_matmul.py:246", "wgmma"),
    ("fused_conv3_fwd", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:55", "wgmma"),
    ("fused_conv3_dx", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:116", "wgmma"),
    ("fused_conv3_dw", "pyspark_tf_gke_tpu_torch/csrc/fused_conv3.cu",
     "pyspark_tf_gke_tpu/ops/pallas/fused_conv3.py:179", "wgmma"),
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
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm
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
    for line in kernels.build_log.splitlines():
        if "Compiling entry function" in line or "Used " in line \
                or "spill" in line:
            log(f"  ptxas: {line.strip()[:150]}")
    for fn, info in ptxas_report(kernels.build_log).items():
        # the tensor-core kernels and K1's decode variant: none may spill
        if any(k in fn for k in NO_SPILL):
            log(f"  ptxas {fn[:90]}: {info['used']}; spill stores "
                f"{info['spill_stores']} B, spill loads "
                f"{info['spill_loads']} B")
            check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                  f"{fn} spills registers")
    for line in kernels.build_log.splitlines():
        if "warning" in line and "wgmma" in line:
            log(f"  ptxas: {line.strip()[:200]}")

    log("== 3. kernels vs plain versions")
    records = {"layernorm": check_layernorm(torch, dev),
               "layernorm_bwd": check_layernorm_bwd(torch, dev),
               "flash_attention_fwd": check_flash(torch, dev),
               **check_flash_bwd(torch, dev),
               "paged_attention": check_paged(torch, dev),
               **check_fused_matmul(torch, dev),
               **check_fused_conv3(torch, dev)}
    log("== 3b. K2 at head widths 128, 32 and 80; K1 at head_dim 128")
    for name, by_width in check_flash_widths(torch, dev).items():
        records[name].update(by_width)
    records["paged_attention"]["d128"] = check_paged_d128(torch, dev)
    for name, rec in records.items():
        log(f"  {name} at {rec['shape']}: kernel_ms {rec['ms']:.4f}, "
            f"plain_ms {rec['plain_ms']:.4f}, library_ms "
            f"{rec['library_ms']:.4f}, bound_ms {rec['bound_ms']:.4f} "
            f"({rec['bound_by']})")

    serve_counters = {"layernorm": (ln, "launches"),
                      "flash_attention_fwd": (fa, "launches"),
                      "paged_attention": (pa, "launches")}
    train_counters = {"layernorm": (ln, "launches"),
                      "layernorm_bwd": (ln, "bwd_launches"),
                      "flash_attention_fwd": (fa, "launches"),
                      "flash_attention_dq": (fa, "dq_launches"),
                      "flash_attention_dkv": (fa, "dkv_launches")}
    from pyspark_tf_gke_tpu_torch.models.causal_lm import CausalLMConfig

    # GPT-small (CausalLMConfig defaults: vocab 32000, hidden 768, 12
    # layers, 12 heads, FFN 3072, 1024 positions, bf16), paged as the
    # cb bench pages it: 64-token pages, slots x 16 of them
    cfg = CausalLMConfig(kv_page_size=64, kv_num_pages=128)
    log("== 4. serving main path: BundleServer + HTTP, GPT-small paged, "
        "8 slots")
    serve_launches, serve_variants, full_model = run_main_path(
        torch, dev, serve_counters, cfg)
    records["paged_attention"]["launches_by_variant"] = serve_variants
    log("== 4b. where the engine's time goes (torch.profiler)")
    profile_engine(torch, full_model)
    log("== 5. serving parity on the card")
    check_parity(torch, dev, full_model, dataclasses.replace(
        cfg, num_layers=2, dtype=torch.float32))
    check_paged_piece(torch, dev, full_model)
    del full_model
    torch.cuda.empty_cache()
    log("== 4c. chunked prefill on the serving path: GPT-small at 2048 "
        "positions, 8 slots, pieces of 256 under a 384-token step budget")
    chunked_launches, chunked_variants = run_chunked_serving(
        torch, dev, serve_counters)
    records["paged_attention"]["launches_by_variant_chunked"] = \
        chunked_variants
    torch.cuda.empty_cache()
    log("== 6. training main path: lm_pretrain, GPT-small width, bf16, "
        "batch 16 x 512")
    train_launches, _ = run_training(torch, dev, train_counters)
    log("== 6b. where a training step's time goes (torch.profiler)")
    profile_training(torch, dev)
    torch.cuda.empty_cache()
    log("== 7. training parity on the card")
    check_training_parity(torch, dev)
    torch.cuda.empty_cache()
    log("== 7b. a training step at GPT-2 large's widths (hidden 1280, 20 "
        "heads): LayerNorm at D = 1280")
    wide_launches = check_wide_lm_step(torch, dev, {
        "layernorm": (ln, "launches"), "layernorm_bwd": (ln, "bwd_launches")})
    torch.cuda.empty_cache()
    log("== 7c. head_dim 128 (hidden 1024, 8 heads): a training step and a "
        "served bundle")
    d128_launches, d128_served = check_d128_lm(torch, dev, train_counters)
    torch.cuda.empty_cache()

    k4_counters = {"fused_matmul_fwd": (fm, "fwd_launches"),
                   "fused_matmul_dx": (fm, "dx_launches"),
                   "fused_matmul_dw": (fm, "dw_launches")}
    k5_counters = {"fused_conv3_fwd": (fc, "fwd_launches"),
                   "fused_conv3_dx": (fc, "dx_launches"),
                   "fused_conv3_dw": (fc, "dw_launches")}
    resnet_counters = {**k4_counters, **k5_counters}
    log("== 8. ResNet-50 training main path: Trainer, norm_variant=fused, "
        "bf16, batch 64 x 224^2")
    resnet_launches, trainer, state, batch = run_resnet_training(
        torch, dev, resnet_counters, "fused")
    log("== 8b. where a ResNet-50 fused step's time goes (torch.profiler), "
        "and the bn variant's step")
    fused_ms = time_resnet(torch, trainer, state, batch, "fused")
    del trainer, state
    torch.cuda.empty_cache()
    bn_ms = time_bn_resnet(torch, dev, batch)
    del batch
    log(f"  fused / bn = {fused_ms / bn_ms:.2f}")
    log("== 9. ResNet-50 fused training parity on the card: kernels vs "
        "plain")
    check_resnet_parity(torch, dev, "fused")
    log("== 10. ResNet-50 training main path: Trainer, norm_variant=fused3, "
        "bf16, batch 64 x 224^2")
    fused3_launches, trainer, state, batch = run_resnet_training(
        torch, dev, resnet_counters, "fused3")
    log("== 10b. where a ResNet-50 fused3 step's time goes (torch.profiler)")
    fused3_ms = time_resnet(torch, trainer, state, batch, "fused3")
    log(f"  fused3 / fused = {fused3_ms / fused_ms:.2f}, fused3 / bn = "
        f"{fused3_ms / bn_ms:.2f} (fused {fused_ms:.2f}, bn {bn_ms:.2f} "
        "ms/step, phase 8b)")
    del trainer, state, batch
    torch.cuda.empty_cache()
    log("== 11. ResNet-50 fused3 training parity on the card: kernels vs "
        "plain")
    check_resnet_parity(torch, dev, "fused3")
    log("== 12. the other ResNet-50 variants: one training step each, "
        "bf16, 8 x 64^2")
    check_resnet_variants(torch, dev, k5_counters)

    out = []
    for name, source, replaces, design in KERNELS:
        rec = records[name]
        per_path = {"serve": serve_launches.get(name, 0),
                    "serve_chunked": chunked_launches.get(name, 0),
                    "lm_train": train_launches.get(name, 0),
                    "lm_train_1280": wide_launches.get(name, 0),
                    "lm_train_d128": d128_launches.get(name, 0),
                    "serve_d128": d128_served.get(name, 0),
                    "resnet_train": resnet_launches.get(name, 0),
                    "resnet_fused3_train": fused3_launches.get(name, 0)}
        # each kernel's count from the path that runs it, the newest
        # slice's path first (paged attention runs only on serving)
        launches = (per_path["resnet_fused3_train"]
                    or per_path["resnet_train"] or per_path["lm_train"]
                    or per_path["serve"])
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "design": design,
                    "launches": launches,
                    "launches_per_path": per_path,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"],
                    **{key: rec[key] for key in EXTRA_KEYS if key in rec}})
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
