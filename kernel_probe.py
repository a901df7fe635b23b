#!/usr/bin/env python3
"""Short measurements of the port's kernels on one card, beside
``chip_smoke.py`` (whose helpers it uses): for the first calls after
editing a ``.cu`` file, and for the experiments PERF.md reports.

    python3 kernel_probe.py check check_flash [check_fused_conv3 ...]
        build the kernels, print the ptxas lines of the kernels that must
        not spill and of K3b, run chip_smoke's check functions by name;
    python3 kernel_probe.py k5-accuracy
        bf16 K5f and its plain version against an f64 reference: y
        elements a bf16 rounding away from it, and the statistics;
    python3 kernel_probe.py k5-modes
        bf16 K5f's time at ResNet-50's stage shapes with and without
        the transform and the statistics;
    python3 kernel_probe.py graph
        K2f, SDPA and K5f eager and replayed from a CUDA graph;
    python3 kernel_probe.py trans-a
        the transposed-A wgmma form once: bf16 K4dw (each CTA tile) and
        K5dw on small-integer inputs, whose f32 sums are exact, must
        equal an f64 reference rounded to bf16 bit for bit;
    python3 kernel_probe.py dw-accuracy
        bf16 K4dw, K5dw and their plain versions against an f64
        reference: dw elements a bf16 rounding away from it and the
        relative L2 (the accumulator granularity is wgmma_dw.cuh's
        kFresh);
    python3 kernel_probe.py dw-modes
        bf16 K4dw and K5dw at ResNet-50's stage shapes with and without
        the transform, eager and replayed from a CUDA graph;
    python3 kernel_probe.py k4-accuracy
        bf16 K4f and K4dx and their plain versions against an f64
        reference: y and dx elements a bf16 rounding away from it, and
        the statistics (y's, and d a, d b; the accumulator granularity
        is fused_matmul.cu's wg::kGroup);
    python3 kernel_probe.py k4-modes
        bf16 K4f and K4dx at the 16 shapes of a ResNet-50 step with and
        without the transform, eager and replayed from a CUDA graph, and
        the sums over a step's 36 calls;
    python3 kernel_probe.py k5dx-accuracy
        bf16 K5dx and its plain version against an f64 reference: dx
        elements a bf16 rounding away from it, and d a, d b (the built
        design: a fresh wgmma accumulator every 64-wide step);
    python3 kernel_probe.py k5dx-modes
        bf16 K5dx at ResNet-50's four stage shapes with and without the
        transform, eager and replayed from a CUDA graph, beside cuDNN's
        conv2d_input, and the sums over a step's 13 calls; then stages 1
        and 3 against shapes of the same M, K and N whose images fill
        every 128-pixel tile (what the whole-row tiles' idle rows cost);
    python3 kernel_probe.py dkv-accuracy
        bf16 K2dkv and the plain backward against an f64 reference that
        rounds P and dS to bf16 where the TPU kernel does: dk and dv
        elements a bf16 rounding away from it, at the LM training shape
        in the three mask cases;
    python3 kernel_probe.py dq-accuracy
        the same for bf16 K2dq: dq elements a bf16 rounding away from the
        f64 reference (dS rounded to bf16 before dQ += dS K);
    python3 kernel_probe.py dkv-modes
        bf16 K2dkv and K2dq at the LM training shape, causal and not,
        eager and replayed from a CUDA graph;
    python3 kernel_probe.py ce-modes
        one chunk product of the chunked loss (f32 sums of bf16
        operands) through ``out_dtype``, TF32 at an unaligned width and
        TF32 padded to a multiple of 8 columns, beside the bf16 product;
    python3 kernel_probe.py ln-widths [D ...]
        bf16 K3 and K3b at [8192, D] (default D 768, 1024, 1280, 1600
        and 4096), with and without the residual, eager and replayed
        from a CUDA graph, beside F.layer_norm (after x + r for the
        residual) and autograd's LayerNorm backward and
        ``native_layer_norm_backward`` on the saved statistics, with the
        bounds;
    python3 kernel_probe.py paged-modes
        bf16 K1 at the four shapes PERF.md reports (8 slots, H = H_kv =
        12, 64-token pages: S = 1 at fills {0..1024}, at 716 each and at
        1024 each; the 256-token piece at fills {0..1024}), eager and
        replayed from a CUDA graph, beside SDPA over the gathered pages,
        with the bounds; then, where the wrapper has a plan, the decode
        variant at each pages-a-split, the decode and chunk variants
        at chunk widths around the threshold, and both at the verify
        widths of speculative decoding (S = 2..8 on the serving decode
        shape, at fills {0..1024} and at 716 each) beside SDPA over the
        gathered pages;
    python3 kernel_probe.py flash-widths [f32] [D ...]
        K2f, K2dq and K2dkv in bf16 (f32 with ``f32``) at head width D
        (default 128, 80 and 64; causal, B=16 S=512 H=8), checked against
        their plain versions, eager and replayed from a CUDA graph,
        beside SDPA forward and backward, the plain versions and the
        bounds (bf16 D 64 and 128 on the tensor cores, other widths and
        f32 on the CUDA cores);
    python3 kernel_probe.py paged-accuracy
        bf16 K1 and its plain version against an f64 reference at the
        checked shape and the 256-token piece: output elements a bf16
        rounding away from it;
    python3 kernel_probe.py serve-path
        chip_smoke's phase 4 three times and phase 4b of the tree this
        file sits in (the served path's new tokens/s, a replayed decode
        chunk's device time and wall): copied into an unpacked parent
        commit, it runs
        that commit's serving path, so parent and change compare in one
        call, in turns.
    python3 kernel_probe.py int8-modes
        K6 of the tree this file sits in, graph-replayed: one GPT-small
        decode step at M = 8 in bf16 over twelve layers' own weights and
        lm_head (110 MB of int8, more than L2 holds; the query, key and
        value one launch where the tree's K6 takes a group, else 73
        launches) and lm_head alone, beside ``torch.matmul`` on the
        weights dequantized to bf16 (73 products) and the bounds, each
        checked against the plain version first; copied into an unpacked
        earlier commit, it times that commit's K6, so two designs
        compare in one call, in turns (parent, change, change, parent);
    python3 kernel_probe.py cublas-workspace
        ``torch.cuda.memory_allocated`` around one bf16 GEMM on the main
        thread, on threads started one after another, on four threads
        alive at once (twice) and on a thread with a stream of its own:
        what cuBLAS keeps for each thread's handle and stream;
    python3 kernel_probe.py p9-seeds [SEED ...]
        phase 13's CNN-B1 loss-parity run (f32, the sizes of
        ``tools/parity_report.json``) from the model's initialisation at
        each seed (default 1337 and 0-6: the JAX init of that seed,
        replayed by ``utils/seeding.jax_init_params``): each run's final
        and best loss, final MAE, and whether the report's gates hold.
    python3 kernel_probe.py gloo-cuda
        two processes in a gloo world on the one card (NCCL refuses two
        ranks on a card), a fresh world for each ``torch.distributed``
        collective the training mesh calls, on CUDA tensors, with a 20 s
        timeout: which the gloo backend takes, which it refuses and
        which abort the process.

Each exits non-zero without a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _ptxas(names) -> None:
    """Build the kernels and print ptxas's registers and spills of the
    named bf16 kernels (none where this process found the library
    built)."""
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import kernels

    kernels.library()
    for fn, info in cs.ptxas_report(kernels.build_log).items():
        for name in names:
            if name in fn:
                print(f"ptxas {fn[fn.index(name):][:40]}: {info['used']}; "
                      f"spill {info['spill_stores']}/{info['spill_loads']} B",
                      flush=True)


def check(torch, dev, names) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import kernels

    print(cs.query_card(), flush=True)
    kernels.library()
    for fn, info in cs.ptxas_report(kernels.build_log).items():
        if any(k in fn for k in cs.NO_SPILL + ("ln_bwd", "flash_", "int8_mm")):
            print("ptxas", fn[:100], info)
    for name in names:
        print(name, getattr(cs, name)(torch, dev))


def k5_accuracy(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    g = torch.Generator(device=dev).manual_seed(9)
    shapes = ((3, 9, 5, 48, 80, None), (3, 9, 5, 48, 80, "relu"),
              (64, 56, 56, 64, 64, None), (64, 14, 14, 256, 256, None),
              (64, 7, 7, 512, 512, None), (64, 7, 7, 512, 512, "relu"))
    for b, h, w, k, n, t in shapes:
        for rep in range(3):
            x, wt, _, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, n,
                                            torch.bfloat16, t)
            relu = t == "relu"
            y, st = fc.conv3_fwd(x, wt, a, bb, relu, True)
            ry, rst = fc.conv3_fwd_plain(x, wt, a, bb, relu, True)
            acc = None
            xn = fc._transform(x, a, bb, relu).double()
            for dh, dw, win in fc._windows(xn, False):
                prod = win @ wt.double()[dh, dw]
                acc = prod if acc is None else acc + prod
            y64 = acc.reshape(y.shape).to(torch.bfloat16).double()
            yr = y64.reshape(-1, n)
            st64 = torch.stack([yr.sum(0), (yr * yr).sum(0)])
            off_k = int((y.double() != y64).sum())
            off_p = int((ry.double() != y64).sum())
            print(f"[{b},{h},{w},{k}]->{n} {t} rep{rep}: statistics "
                  f"kernel-vs-plain {_rel(st, rst):.2e}, kernel-vs-f64 "
                  f"{_rel(st, st64):.2e}, plain-vs-f64 {_rel(rst, st64):.2e};"
                  f" y off f64 by a rounding: kernel {off_k}, plain {off_p} "
                  f"of {y.numel()}", flush=True)


def k5_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    g = torch.Generator(device=dev).manual_seed(9)
    for b, h, w, k, count in cs.RESNET50_K5_SHAPES:
        x, wt, _, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, k,
                                        torch.bfloat16, "relu")
        line = []
        for mode, aa, bbb, relu in (("relu", a, bb, True),
                                    ("plain", None, None, False)):
            for stats in (True, False):
                ms = cs.cuda_ms(
                    lambda: fc.conv3_fwd(x, wt, aa, bbb, relu, stats),
                    warmup=3, iters=10, reps=5)
                line.append(f"{mode}{'+stats' if stats else ''} {ms:.4f}")
        print(f"K5f [{b},{h},{w},{k}] x{count}: {', '.join(line)} ms",
              flush=True)


def graph(torch, dev) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    g = torch.Generator(device=dev).manual_seed(1)
    for b, s in ((8, 1024), (16, 512)):
        q, k, v = (torch.randn(b, s, 12, 64, generator=g, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        calls = (("K2f", lambda: fa.flash_attention_fwd(q, k, v,
                                                       causal=True)),
                 ("SDPA", lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=True)))
        for name, fn in calls:
            print(f"B={b} S={s} {name}: eager {cs.cuda_ms(fn):.4f} ms, "
                  f"graph {cs.graph_ms(fn):.4f} ms", flush=True)
    for b, h, w, k, _ in cs.RESNET50_K5_SHAPES:
        x, wt, _, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, k,
                                        torch.bfloat16, "relu")
        fn = lambda: fc.conv3_fwd(x, wt, a, bb, True, True)  # noqa: E731
        print(f"K5f [{b},{h},{w},{k}]: eager "
              f"{cs.cuda_ms(fn, warmup=1, iters=3, reps=3):.4f} ms, graph "
              f"{cs.graph_ms(fn, 5):.4f} ms", flush=True)


# bf16 dw shapes: K4 (M, K, N) one of each CTA tile (64 or 128 along K
# and N) and the ragged edge path; K5 (B, H, W, K, N) the four stages
# and a ragged one
DW_K4_SHAPES = ((200704, 64, 64), (200704, 64, 256), (200704, 256, 64),
                (3136, 2048, 512), (1000, 72, 40))
DW_K5_SHAPES = ((64, 56, 56, 64, 64), (64, 28, 28, 128, 128),
                (64, 14, 14, 256, 256), (64, 7, 7, 512, 512),
                (3, 9, 5, 48, 80), (2, 6, 7, 12, 20))


def _dw_reference(torch, fc, op, x, dy, a, b, relu):
    """f64 dw from the bf16-rounded transformed input (K4: [K, N];
    K5: [3, 3, K, N])."""
    xn = fc._transform(x, a, b, relu).double()
    if op == "K4":
        return xn.t() @ dy.double()
    n = dy.shape[-1]
    dyd = dy.double().reshape(-1, n)
    return torch.stack([win.t() @ dyd for _, _, win in
                        fc._windows(xn, False)]).reshape(3, 3, -1, n)


def _dw_cases(torch, dev, g, transform="relu", ints=False):
    """``(op, tag, x, dy, a, b, relu)`` for every bf16 dw shape."""
    import chip_smoke as cs

    def draw(*shape):
        if ints:  # small integers: exact products and f32 sums
            return torch.randint(-3, 4, shape, generator=g,
                                 device=dev).to(torch.bfloat16)
        return torch.randn(*shape, generator=g,
                           device=dev).to(torch.bfloat16)

    for m, k, n in DW_K4_SHAPES:
        x, dy = draw(m, k), draw(m, n)
        a = b = None
        if transform is not None:
            _, _, _, a, b = cs._k4_inputs(torch, dev, g, 8, k, n,
                                          torch.bfloat16, transform)
        yield "K4", f"K4dw M={m} K={k} N={n}", x, dy, a, b, transform == "relu"
    for bb, h, w, k, n in DW_K5_SHAPES:
        x, dy = draw(bb, h, w, k), draw(bb, h, w, n)
        a = b = None
        if transform is not None:
            _, _, _, a, b = cs._k5_inputs(torch, dev, g, 1, 1, 1, k, n,
                                          torch.bfloat16, transform)
        yield ("K5", f"K5dw x=[{bb},{h},{w},{k}] N={n}", x, dy, a, b,
               transform == "relu")


def _dw_fns(fm, fc, op):
    return ((fm.norm_relu_matmul_dw, fm.norm_relu_matmul_dw_plain)
            if op == "K4" else (fc.conv3_dw, fc.conv3_dw_plain))


def trans_a(torch, dev) -> None:
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    g = torch.Generator(device=dev).manual_seed(5)
    bad = 0
    for op, tag, x, dy, a, b, relu in _dw_cases(torch, dev, g, None, True):
        got = _dw_fns(fm, fc, op)[0](x, dy, a, b, relu)
        want = _dw_reference(torch, fc, op, x, dy, a, b, relu).to(
            torch.bfloat16)
        off = int((got != want).sum())
        bad += off
        print(f"trans-a {tag} integer inputs: {off} of {got.numel()} "
              f"elements differ from f64 (max |diff| "
              f"{float((got.double() - want.double()).abs().max()):g})",
              flush=True)
    if bad:
        raise SystemExit("trans-a: the tensor-core dw disagrees with f64")


def dw_accuracy(torch, dev) -> None:
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    for transform in ("relu", None):
        g = torch.Generator(device=dev).manual_seed(9)
        for op, tag, x, dy, a, b, relu in _dw_cases(torch, dev, g,
                                                    transform):
            kern, plain = _dw_fns(fm, fc, op)
            ref = _dw_reference(torch, fc, op, x, dy, a, b, relu)
            ref16 = ref.to(torch.bfloat16).double()
            pl = plain(x, dy, a, b, relu)
            got = kern(x, dy, a, b, relu)
            print(f"{tag} {transform or 'plain'} ({ref.numel()} elements): "
                  f"plain off {int((pl.double() != ref16).sum())} rel "
                  f"{_rel(pl, ref):.2e}; kernel off "
                  f"{int((got.double() != ref16).sum())} rel "
                  f"{_rel(got, ref):.2e} vs plain {_rel(got, pl):.2e}",
                  flush=True)


def dw_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    g = torch.Generator(device=dev).manual_seed(9)
    for transform in ("relu", None):
        for op, tag, x, dy, a, b, relu in _dw_cases(torch, dev, g,
                                                    transform):
            kern = _dw_fns(fm, fc, op)[0]
            fn = lambda: kern(x, dy, a, b, relu)  # noqa: E731
            print(f"{tag} {transform or 'plain'}: eager "
                  f"{cs.cuda_ms(fn, warmup=2, iters=5, reps=5):.4f} graph "
                  f"{cs.graph_ms(fn, 5):.4f} ms", flush=True)


# K4 (M, K, N, transform) for the accuracy probe: K from 64 to 2048, both
# tile widths, and the ragged vector path
K4_ACC_SHAPES = ((200704, 64, 256, "relu"), (200704, 256, 64, None),
                 (50176, 512, 128, None), (12544, 1024, 256, None),
                 (3136, 2048, 512, None), (3136, 512, 2048, "relu"),
                 (1000, 72, 40, "affine"))


def _k4_f64(torch, fm, x, w, dy, a, b, relu):
    """f64 references of K4f (y rounded to bf16, its statistics) and
    K4dx (dx rounded to bf16, d a and d b), from the bf16 inputs, with
    the relu mask of the f32 transform the kernels and plain versions
    use."""
    y = (fm._transform(x, a, b, relu).double() @ w.double()).to(
        torch.bfloat16).double()
    ystats = torch.stack([y.sum(0), (y * y).sum(0)])
    u = dy.double() @ w.double().t()
    if a is None:
        return y, ystats, u.to(torch.bfloat16).double(), None
    xf = x.float()
    if relu:
        u = torch.where(xf * a + b > 0, u, torch.zeros_like(u))
    dx = (u * a.double()).to(torch.bfloat16).double()
    return y, ystats, dx, torch.stack([(u * xf.double()).sum(0), u.sum(0)])


def k4_accuracy(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    _ptxas(("k4_fwd_wgmma", "k4_dx_wgmma"))
    g = torch.Generator(device=dev).manual_seed(8)
    for m, k, n, t in K4_ACC_SHAPES:
        x, w, dy, a, b = cs._k4_inputs(torch, dev, g, m, k, n,
                                       torch.bfloat16, t)
        relu = t == "relu"
        y, st = fm.norm_relu_matmul_fwd(x, w, a, b, relu, True)
        ry, rst = fm._fwd_plain(x, w, a, b, relu, True)
        dx, ds = fm.norm_relu_matmul_dx(dy, w, x, a, b, relu)
        rdx, rds = fm.norm_relu_matmul_dx_plain(dy, w, x, a, b, relu)
        y64, st64, dx64, ds64 = _k4_f64(torch, fm, x, w, dy, a, b, relu)
        line = (f"M={m} K={k} N={n} {t or 'plain'}: y off f64 by a "
                f"rounding: kernel {int((y.double() != y64).sum())}, plain "
                f"{int((ry.double() != y64).sum())} of {y.numel()}; stats "
                f"rel kernel {_rel(st, st64):.2e}, plain "
                f"{_rel(rst, st64):.2e}; dx off: kernel "
                f"{int((dx.double() != dx64).sum())}, plain "
                f"{int((rdx.double() != dx64).sum())} of {dx.numel()}")
        if ds64 is not None:
            line += (f"; d a, d b rel kernel {_rel(ds, ds64):.2e}, "
                     f"plain {_rel(rds, ds64):.2e}")
        print(line, flush=True)
        del x, w, dy, y, ry, dx, rdx, y64, dx64
    torch.cuda.empty_cache()


def k4_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_matmul as fm

    _ptxas(("k4_fwd_wgmma", "k4_dx_wgmma"))
    sums = {}
    g = torch.Generator(device=dev).manual_seed(9)
    for m, k, n, _, count in cs.RESNET50_K4_SHAPES:
        x, w, dy, a, b = cs._k4_inputs(torch, dev, g, m, k, n, torch.bfloat16,
                                       "relu")
        for mode, aa, bb, relu in (("relu", a, b, True),
                                   ("plain", None, None, False)):
            calls = (("K4f", lambda: fm.norm_relu_matmul_fwd(
                         x, w, aa, bb, relu, True)),
                     ("K4dx", lambda: fm.norm_relu_matmul_dx(
                         dy, w, x, aa, bb, relu)))
            for op, fn in calls:
                eager = cs.cuda_ms(fn, warmup=2, iters=5, reps=5)
                graph = cs.graph_ms(fn, 5)
                e0, g0 = sums.get((op, mode), (0.0, 0.0))
                sums[(op, mode)] = (e0 + count * eager, g0 + count * graph)
                print(f"{op} M={m} K={k} N={n} {mode} x{count}: eager "
                      f"{eager:.4f} graph {graph:.4f} ms", flush=True)
        del x, w, dy
    for (op, mode), (eager, graph) in sums.items():
        print(f"{op} {mode}, a step's 36 calls: eager {eager:.4f} "
              f"graph {graph:.4f} ms", flush=True)


# K5dx (B, H, W, K = N, transform) for the accuracy probe: the four
# stages with and without the transform, and the ragged vector path
K5DX_ACC_SHAPES = tuple((b, h, w, k, t) for b, h, w, k, _ in (
    (64, 56, 56, 64, 3), (64, 28, 28, 128, 3), (64, 14, 14, 256, 5),
    (64, 7, 7, 512, 2)) for t in ("relu", None)) + (
    (3, 9, 5, 48, "affine"),)


def _k5dx_f64(torch, fc, dy, w, x, a, b, relu):
    """f64 reference of K5dx from the bf16 inputs: dx rounded to bf16,
    d a and d b, with the relu mask of the f32 transform the kernel and
    the plain version use."""
    u = None
    for dh, dw, win in fc._windows(dy.double(), True):
        prod = win @ w.double()[dh, dw].t()
        u = prod if u is None else u + prod
    xf = x.reshape(-1, x.shape[-1]).float()
    if a is None:
        return u.to(torch.bfloat16).double(), None
    if relu:
        u = torch.where(xf * a + b > 0, u, torch.zeros_like(u))
    dx = (u * a.double()).to(torch.bfloat16).double()
    return dx, torch.stack([(u * xf.double()).sum(0), u.sum(0)])


def k5dx_accuracy(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    _ptxas(("k5_dx_wgmma",))
    g = torch.Generator(device=dev).manual_seed(8)
    for b, h, w, k, t in K5DX_ACC_SHAPES:
        x, wt, dy, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, k,
                                         torch.bfloat16, t)
        relu = t == "relu"
        dx, ds = fc.conv3_dx(dy, wt, x, a, bb, relu)
        rdx, rds = fc.conv3_dx_plain(dy, wt, x, a, bb, relu)
        dx64, ds64 = _k5dx_f64(torch, fc, dy, wt, x, a, bb, relu)
        dx, rdx = dx.reshape(dx64.shape), rdx.reshape(dx64.shape)
        line = (f"K5dx x=[{b},{h},{w},{k}] {t or 'plain'}: dx off f64 by a "
                f"rounding: kernel {int((dx.double() != dx64).sum())}, plain "
                f"{int((rdx.double() != dx64).sum())} of {dx.numel()}")
        if ds64 is not None:
            line += (f"; d a, d b rel kernel {_rel(ds, ds64):.2e}, plain "
                     f"{_rel(rds, ds64):.2e}")
        print(line, flush=True)
        del x, wt, dy, dx, rdx, dx64
    torch.cuda.empty_cache()


def k5dx_modes(torch, dev) -> None:
    from torch.nn import grad as conv_grad

    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as fc

    _ptxas(("k5_dx_wgmma",))
    sums = {}
    g = torch.Generator(device=dev).manual_seed(9)
    for b, h, w, k, count in cs.RESNET50_K5_SHAPES:
        x, wt, dy, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, k,
                                         torch.bfloat16, "relu")
        x_c, dy_c = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        w_c = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        calls = (("K5dx relu", lambda: fc.conv3_dx(dy, wt, x, a, bb, True)),
                 ("K5dx plain", lambda: fc.conv3_dx(dy, wt, x, None, None,
                                                    False)),
                 ("cuDNN conv2d_input", lambda: conv_grad.conv2d_input(
                     x_c.shape, w_c, dy_c, padding=1)))
        for name, fn in calls:
            eager = cs.cuda_ms(fn, warmup=2, iters=5, reps=5)
            graph = cs.graph_ms(fn, 5)
            e0, g0 = sums.get(name, (0.0, 0.0))
            sums[name] = (e0 + count * eager, g0 + count * graph)
            print(f"{name} x=[{b},{h},{w},{k}] x{count}: eager {eager:.4f} "
                  f"graph {graph:.4f} ms", flush=True)
        del x, wt, dy, x_c, dy_c, w_c
    torch.cuda.empty_cache()
    for name, (eager, graph) in sums.items():
        print(f"{name}, a step's 13 calls: eager {eager:.4f} graph "
              f"{graph:.4f} ms", flush=True)
    # what the whole-row tiles' idle rows cost: a stage shape against one
    # of the same M, K and N whose images fill every 128-row tile
    for shape, full in (((64, 56, 56, 64), (49, 64, 64, 64)),
                        ((64, 14, 14, 256), (49, 16, 16, 256))):
        line = []
        for b, h, w, k in (shape, full):
            (nb, rows, wc), tiles = fc.k5dx_plan(b, h, w, torch.bfloat16)
            x, wt, dy, a, bb = cs._k5_inputs(torch, dev, g, b, h, w, k, k,
                                             torch.bfloat16, "relu")
            fn = lambda: fc.conv3_dx(dy, wt, x, a, bb, True)  # noqa: E731
            line.append(f"x=[{b},{h},{w},{k}] {tiles} tiles of "
                        f"{nb * rows * wc} pixels: graph "
                        f"{cs.graph_ms(fn, 5):.4f} ms")
            del x, wt, dy
        print(f"K5dx tile fill, M={b * h * w}: {'; '.join(line)}", flush=True)


def _bwd_f64(torch, fa, q, k, v, dout, lse, delta, kv_mask, segs):
    """f64 reference of dq, dk, dv with P and dS rounded to bf16 where
    the TPU kernels round them, each rounded to bf16 at the end."""
    qd, kd, vd, dod = (t.double() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if kv_mask is not None:
        s = s + torch.where(kv_mask.bool(), 0.0, fa.NEG_INF).double()[
            :, None, None, :]
    keep = fa._causal_mask(fa._mask(None, segs), q.shape[1], k.shape[1],
                           q.device)
    s = torch.where(keep, s, fa.NEG_INF)
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
    ds = p * (dp - delta.double()[..., None]) * scale
    del s, dp
    p = p.to(torch.bfloat16).double()
    ds = ds.to(torch.bfloat16).double()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dod)
    return tuple(t.to(torch.bfloat16).double() for t in (dq, dk, dv))


def _bwd_accuracy(torch, dev, which) -> None:
    """bf16 K2dq ("dq") or K2dkv ("dkv") and the plain backward against
    ``_bwd_f64`` at the LM training shape in the three mask cases."""
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    _ptxas((f"flash_{which}_wgmma",))
    g = torch.Generator(device=dev).manual_seed(6)
    for case in ("causal", "segments", "masked"):
        q, k, v, dout, kv_mask, segs = cs._flash_bwd_case(
            torch, dev, g, torch.bfloat16, case)
        out, lse = fa.flash_attention_fwd(q, k, v, kv_mask, True, segs)
        delta = (dout.float() * out.float()).sum(-1).transpose(
            1, 2).contiguous()
        if which == "dq":
            got = (fa.flash_attention_dq(dout, q, k, v, lse, delta, kv_mask,
                                         True, segs),)
        else:
            got = fa.flash_attention_dkv(dout, q, k, v, lse, delta, kv_mask,
                                         True, segs)
        plain = fa.flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                             kv_mask, True, segs)
        ref = _bwd_f64(torch, fa, q, k, v, dout, lse, delta, kv_mask, segs)
        names = ("dq",) if which == "dq" else ("dk", "dv")
        first = 0 if which == "dq" else 1
        parts = []
        for i, name in enumerate(names):
            kern, pl, want = got[i], plain[first + i], ref[first + i]
            parts.append(
                f"{name} kernel {int((kern.double() != want).sum())}, plain "
                f"{int((pl.double() != want).sum())} (rel kernel "
                f"{_rel(kern, want):.2e}, plain {_rel(pl, want):.2e})")
        print(f"K2{which} {case} B=16 S=512 H=12 D=64: elements off f64 by a "
              f"rounding of {q.numel()}: {'; '.join(parts)}", flush=True)
        del ref, plain, got
        torch.cuda.empty_cache()


def dkv_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa

    _ptxas(("flash_dkv_wgmma",))
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, dout, _, _ = cs._flash_bwd_case(torch, dev, g, torch.bfloat16,
                                             "causal")
    for causal in (True, False):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = (dout.float() * out.float()).sum(-1).transpose(
            1, 2).contiguous()
        calls = (("K2dkv", lambda: fa.flash_attention_dkv(
                     dout, q, k, v, lse, delta, causal=causal)),
                 ("K2dq", lambda: fa.flash_attention_dq(
                     dout, q, k, v, lse, delta, causal=causal)))
        for name, fn in calls:
            print(f"{name} B=16 S=512 H=12 D=64 "
                  f"{'causal' if causal else 'full'}: eager "
                  f"{cs.cuda_ms(fn):.4f} graph {cs.graph_ms(fn):.4f} ms",
                  flush=True)


LN_WIDTHS = (768, 1024, 1280, 1600, 4096)


def ln_widths(torch, dev, widths) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(0)
    for d in widths or LN_WIDTHS:
        x, r, dy = ((torch.randn(8192, d, generator=g, device=dev) * 2 + 0.5
                     ).to(torch.bfloat16) for _ in range(3))
        scale, bias = (torch.randn(d, generator=g, device=dev)
                       for _ in range(2))
        w, b = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        print(f"D={d}: {ln.ln_plan(d, torch.bfloat16)}", flush=True)
        row = x.numel() * x.element_size()
        for res in (None, r):
            tag = f"[8192,{d}] bf16{' +residual' if res is not None else ''}"
            rows_in = 1 if res is None else 2
            # K3: x (and r) read, y written, scale and bias read; K3b: x
            # (and r), g read, dx written, scale read, dscale and dbias
            # written
            fwd_bound = cs.bound((rows_in + 1) * row + 2 * d * 4,
                                 8 * x.numel(), "float32")
            bwd_bound = cs.bound((rows_in + 2) * row + 3 * d * 4,
                                 17 * x.numel(), "float32")
            fwd = lambda: ln.layernorm_fwd(x, scale, bias, 1e-5,  # noqa: E731
                                           res)
            bwd = lambda: ln.layernorm_bwd(dy, x, scale, 1e-5,  # noqa: E731
                                           res)
            lib = (lambda: F.layer_norm(x, (d,), w, b, 1e-5)  # noqa: E731
                   ) if res is None else (
                lambda: F.layer_norm(x + r, (d,), w, b, 1e-5))
            xr = x.detach().requires_grad_()
            wr, br = (t.detach().requires_grad_() for t in (w, b))
            y = F.layer_norm(xr if res is None else xr + r, (d,), wr, br,
                             1e-5)
            lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                y, (xr, wr, br), dy, retain_graph=True)
            print(f"K3 {tag}: eager {cs.cuda_ms(fwd):.4f} graph "
                  f"{cs.graph_ms(fwd):.4f} ms, bound {fwd_bound[0]:.4f} "
                  f"({fwd_bound[1]}); F.layer_norm eager "
                  f"{cs.cuda_ms(lib):.4f} graph {cs.graph_ms(lib):.4f}",
                  flush=True)
            native = _native_ln_bwd(torch, x if res is None else x + r,
                                    dy, w, b)
            print(f"K3b {tag}: eager {cs.cuda_ms(bwd):.4f} graph "
                  f"{cs.graph_ms(bwd):.4f} ms, bound {bwd_bound[0]:.4f} "
                  f"({bwd_bound[1]}); autograd LayerNorm backward eager "
                  f"{cs.cuda_ms(lib_bwd):.4f}; native_layer_norm_backward "
                  f"eager {cs.cuda_ms(native):.4f} graph "
                  f"{cs.graph_ms(native):.4f}", flush=True)
            del y, xr
        del x, r, dy
    torch.cuda.empty_cache()


def _native_ln_bwd(torch, x, dy, w, b):
    """One PyTorch call computing K3b's function (the library yardstick,
    never called by the port): ``native_layer_norm_backward`` on the
    statistics ``native_layer_norm`` saves."""
    d = x.shape[-1]
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], w, b, 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [d], mean, rstd, w, b, [True, True, True])


# The shapes PERF.md reports K1 at (8 slots of 16 pages of 64 tokens, H
# = H_kv = 12, D = 64, bf16): (name, fills, S)
PAGED_SHAPES = (("a: checked, S=1", None, 1),
                ("b: serving decode, S=1", (716,) * 8, 1),
                ("c: full pool, S=1", (1024,) * 8, 1),
                ("d: 256-token piece", None, 256))


def _paged_shape(torch, dev, fills, s, seed=11, hkv=12):
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(seed)
    return cs._paged_case(torch, dev, g, torch.bfloat16, hkv, s, False,
                          cs.PAGED_FILLS if fills is None else fills)


def paged_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    print(cs.query_card(), flush=True)
    _ptxas(("paged",))
    planned = hasattr(pa, "paged_plan")
    for name, fills, s in PAGED_SHAPES:
        q, kp, vp, table, fills_t, _, _ = _paged_shape(torch, dev, fills, s)
        kern = lambda: pa.paged_attention_chunk(  # noqa: E731
            q, kp, vp, table, fills_t)
        lib = lambda: cs._sdpa_over_gathered(  # noqa: E731
            torch, q, kp, vp, table, fills_t)
        bms, by = cs._paged_bound(q, kp, table, fills_t)
        plan = (pa.paged_plan(*_plan_args(q, kp, table)) if planned
                else None)
        print(f"K1 {name}: eager {cs.cuda_ms(kern):.4f} graph "
              f"{cs.graph_ms(kern):.4f} ms; SDPA over gathered pages eager "
              f"{cs.cuda_ms(lib):.4f} graph {cs.graph_ms(lib):.4f}; bound "
              f"{bms:.4f} ({by}); plan {plan}", flush=True)
        if not planned:
            continue
        if s == 1:  # the decode variant at each split size
            for pps in (1, 2, 3, 4, 6, 8, 16):
                pl = pa.paged_plan(*_plan_args(q, kp, table),
                                   pages_per_split=pps)
                fn = lambda: pa._launch(  # noqa: E731
                    q, kp, vp, table, fills_t, None, None, pl)
                print(f"  decode pages_per_split={pps} ({pl.splits} "
                      f"splits): graph {cs.graph_ms(fn):.4f} ms", flush=True)
    if not planned:
        return
    # the decode/chunk threshold: both variants at widths around it
    for hkv in (12, 4):
        for s in (4, 8, 16, 32, 64, 128):
            q, kp, vp, table, fills_t, _, _ = _paged_shape(
                torch, dev, None, s, hkv=hkv)
            times = []
            for variant in ("decode", "chunk"):
                pl = pa.paged_plan(*_plan_args(q, kp, table), variant=variant)
                fn = lambda: pa._launch(  # noqa: E731
                    q, kp, vp, table, fills_t, None, None, pl)
                times.append(f"{variant} {cs.graph_ms(fn):.4f}")
            print(f"  S={s} H_kv={hkv} (R={s * 12 // hkv}) graph: "
                  f"{', '.join(times)} ms; plan "
                  f"{pa.paged_plan(*_plan_args(q, kp, table)).variant}",
                  flush=True)
    # the verify widths of speculative decoding (S = k + 1) on the
    # GPT-small decode shape, at fills {0..1024} and at 716 each
    for label, fills in (("fills {0..1024}", None), ("fills 716", (716,) * 8)):
        for s in range(2, 9):
            q, kp, vp, table, fills_t, _, _ = _paged_shape(
                torch, dev, fills, s)
            times = []
            for variant in ("decode", "chunk"):
                pl = pa.paged_plan(*_plan_args(q, kp, table), variant=variant)
                fn = lambda: pa._launch(  # noqa: E731
                    q, kp, vp, table, fills_t, None, None, pl)
                times.append(f"{variant} {cs.graph_ms(fn):.4f}")
            bms, by = cs._paged_bound(q, kp, table, fills_t)
            lib = lambda: cs._sdpa_over_gathered(  # noqa: E731
                torch, q, kp, vp, table, fills_t)
            print(f"  verify S={s} H_kv=12 {label} graph: "
                  f"{', '.join(times)} ms; SDPA over gathered pages "
                  f"{cs.graph_ms(lib):.4f}; bound {bms:.4f} ({by}); plan "
                  f"{pa.paged_plan(*_plan_args(q, kp, table)).variant}",
                  flush=True)


def _plan_args(q, kp, table):
    b, s, h, d = q.shape
    return (b, s, h, kp.shape[2], d, kp.shape[1], table.shape[1], q.dtype,
            kp.dtype)


def _paged_f64(torch, q, kp, vp, table, fills):
    """The chunk reference in f64 (no rounding inside), rounded to bf16."""
    n, p, hkv, d = kp.shape
    b, s, h, _ = q.shape
    g = h // hkv
    safe = table.long().clamp(0, n - 1)
    k = kp[safe].reshape(b, -1, hkv, d).double()
    v = vp[safe].reshape(b, -1, hkv, d).double()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", q.double().reshape(b, s, hkv, g,
                                                              d), k) * d ** -0.5
    q_abs = fills.long()[:, None] - s + torch.arange(s, device=q.device)
    valid = (torch.arange(k.shape[1], device=q.device)[None, None]
             <= q_abs[:, :, None])
    sc = sc.masked_fill(~valid[:, None, None], float("-inf"))
    pr = torch.softmax(sc, -1).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr, v).reshape(b, s, h, d)
    return out.masked_fill((q_abs < 0)[:, :, None, None], 0.0).to(
        torch.bfloat16).double()


def paged_accuracy(torch, dev) -> None:
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    for name, fills, s in (PAGED_SHAPES[0], PAGED_SHAPES[3]):
        q, kp, vp, table, fills_t, _, _ = _paged_shape(torch, dev, fills, s)
        kern = pa.paged_attention_chunk(q, kp, vp, table, fills_t).double()
        plain = pa.paged_attention_chunk_plain(q, kp, vp, table,
                                               fills_t).double()
        ref = _paged_f64(torch, q, kp, vp, table, fills_t)
        print(f"K1 {name}: elements off f64 by a bf16 rounding of "
              f"{q.numel()}: kernel {int((kern != ref).sum())}, plain "
              f"{int((plain != ref).sum())} (rel kernel {_rel(kern, ref):.2e}"
              f", plain {_rel(plain, ref):.2e})", flush=True)


def flash_widths(torch, dev, args) -> None:
    import chip_smoke as cs

    dtype = torch.float32 if "f32" in args else torch.bfloat16
    widths = [int(a) for a in args if a != "f32"] or (128, 80, 64)
    g = torch.Generator(device=dev).manual_seed(16)
    for d in widths:
        print(f"D={d}", cs.time_flash_width(torch, dev, g, d, dtype=dtype),
              flush=True)


def serve_path(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import flash_attention as fa
    from pyspark_tf_gke_tpu_torch.ops import layernorm as ln
    from pyspark_tf_gke_tpu_torch.ops import paged_attention as pa

    print(cs.query_card(), ROOT, flush=True)
    counters = cs._serve_counters()
    for _ in range(3):  # phase 4's aggregate is a ~0.7 s burst: repeat it
        _, _, model = cs.run_main_path(torch, dev, counters,
                                       cs._serving_cfg())
    print("decode chunk wall median (ms), profiled (wall, device)",
          cs.profile_engine(torch, model), flush=True)


def int8_modes(torch, dev) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import int8_matmul as im

    print(cs.query_card(), ROOT, flush=True)
    _ptxas(("int8_mm",))
    g = torch.Generator(device=dev).manual_seed(18)
    bf16 = torch.bfloat16
    grouped = hasattr(im, "int8_matmul_group")
    qkv = ("query", "key", "value")

    def weight(k, n):
        q, scale = cs._int8_weight(torch, dev, g, k, n)
        return q, scale, (q.float() * scale).to(bf16)

    layers = [{name: weight(k, n) for name, (k, n) in (
        ("query", (768, 768)), ("key", (768, 768)), ("value", (768, 768)),
        ("out", (768, 768)), ("mlp_in", (768, 3072)),
        ("mlp_out", (3072, 768)))} for _ in range(12)]
    head = weight(768, 32000)
    x = {768: torch.randn(8, 768, generator=g, device=dev).to(bf16),
         3072: torch.randn(8, 3072, generator=g, device=dev).to(bf16)}

    def one(w):
        return im.int8_matmul(x[w[0].shape[0]], w[0], w[1])

    def step():
        for lay in layers:
            if grouped:
                im.int8_matmul_group(x[768], [lay[n][:2] for n in qkv])
            for name, w in lay.items():
                if not (grouped and name in qkv):
                    one(w)
        one(head)

    def step_lib():
        for lay in layers:
            for w in lay.values():
                torch.matmul(x[w[0].shape[0]], w[2])
        torch.matmul(x[768], head[2])

    for w in (layers[0]["query"], layers[0]["mlp_out"], head):
        ref = im.int8_matmul_plain(x[w[0].shape[0]], w[0], w[1])
        cs.compare(one(w), ref, "bfloat16", f"K6 {tuple(w[0].shape)}")
    if grouped:
        for w, y in zip((layers[0][n] for n in qkv), im.int8_matmul_group(
                x[768], [layers[0][n][:2] for n in qkv])):
            cs.compare(y, im.int8_matmul_plain(x[768], w[0], w[1]),
                       "bfloat16", "K6 grouped query/key/value")
    before = im.launches
    step()
    calls = im.launches - before
    step_bound = sum(cs._int8_bound(8, w[0].shape[0], w[0].shape[1],
                                    "bfloat16")[0]
                     for lay in layers for w in lay.values())
    head_bound = cs._int8_bound(8, 768, 32000, "bfloat16")[0]
    step_bound += head_bound
    for label, fn, lib, bms in (
            (f"one GPT-small decode step ({calls} launches)", step,
             step_lib, step_bound),
            ("lm_head [8,768]x[768,32000]", lambda: one(head),
             lambda: torch.matmul(x[768], head[2]), head_bound)):
        print(f"K6 {label}, M=8 bf16, graph-replayed "
              f"{cs.graph_ms(fn, calls=4):.4f} ms; torch.matmul on "
              f"dequantized bf16 weights {cs.graph_ms(lib, calls=4):.4f}; "
              f"bound {bms:.4f} (bytes); {cs.CARD}", flush=True)


def cublas_workspace(torch, dev) -> None:
    import gc
    import json
    import threading

    import chip_smoke as cs

    a = torch.randn(768, 768, device=dev, dtype=torch.bfloat16)

    def mib() -> float:
        gc.collect()
        torch.cuda.synchronize(dev)
        return torch.cuda.memory_allocated(dev) / 2**20

    def gemm(own_stream=False) -> None:
        stream = torch.cuda.Stream(dev) if own_stream else None
        with torch.cuda.stream(stream):
            (a @ a).float().sum().item()

    def on_threads(n, own_stream=False) -> None:
        gate = threading.Barrier(n)

        def run():
            gemm(own_stream)
            gate.wait()  # every handle held until all n have run

        threads = [threading.Thread(target=run) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    base = mib()
    rows = []
    for what, fn in (
            ("main thread, first GEMM", gemm),
            ("main thread, second GEMM", gemm),
            ("a new thread", lambda: on_threads(1)),
            ("another new thread, after the first ended",
             lambda: on_threads(1)),
            ("4 threads alive at once", lambda: on_threads(4)),
            ("4 threads alive at once, again", lambda: on_threads(4)),
            ("a new thread on a stream of its own",
             lambda: on_threads(1, own_stream=True))):
        before = mib()
        fn()
        rows.append({"step": what, "delta_mib": mib() - before})
    print(json.dumps({"card": cs.query_card(), "torch": torch.__version__,
                      "base_mib": base, "rows": rows,
                      "total_mib": mib() - base}), flush=True)


def p9_seeds(torch, dev, seeds) -> None:
    import json

    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
    from pyspark_tf_gke_tpu_torch.train.harness import make_optimizer
    from pyspark_tf_gke_tpu_torch.train.trainer import TASKS, Trainer

    section = json.loads(cs.PARITY_REPORT.read_text())["cnn_b1"]
    cfg, opt, gates = section["config"], section["optimizer"], \
        section["checks"]
    lg = gates["final_loss_not_worse_than_tf_best"]
    mg = gates["final_mae_not_worse_than_tf_best"]
    images, targets = cs.make_spot_arrays(cfg["images"], cfg["height"],
                                          cfg["width"], seed=1337)
    card = cs.query_card()
    for seed in seeds or [1337, 0, 1, 2, 3, 4, 5, 6]:
        model = CNNRegressor(flat=True, device=dev, seed=seed,
                             image_size=(cfg["height"], cfg["width"]))
        trainer = Trainer(model, TASKS["regression"](), tx=make_optimizer(
            opt["lr"], eps=opt["eps"]))
        hist = cs._epoch_history(torch, trainer,
                                 {"image": images, "target": targets},
                                 cfg["batch_size"], cfg["epochs"],
                                 ("loss", "mae"))
        final, mae = hist["loss"][-1], hist["mae"][-1]
        print(json.dumps({
            "seed": seed, "final_loss": final, "best_loss": min(hist["loss"]),
            "final_mae": mae, "loss_gate": final <= lg["tf_best"] * lg["tol"],
            "mae_gate": mae <= mg["tf_best"] * (1 + mg["tol"]),
            "card": card}), flush=True)
        del model, trainer
        torch.cuda.empty_cache()


def ce_modes(torch, dev) -> None:
    """One chunk's product of the chunked loss at the LM training shape
    (N = 16 x 511 rows, E = 768, one of 8 chunks of V = 50257: 6283
    columns) with f32 sums of bf16 operands, three ways: ``torch.mm``
    with ``out_dtype=torch.float32``, an f32 upcast with TF32 allowed at
    6283 columns, and the same padded to 6288 (``ops/chunked_ce.py``);
    beside them the bf16 product, rounded to bf16 (which the loss may
    not use). Each mode's ms (CUDA events), its kernels (the profiler)
    and its max error against the f32 product of the same values."""
    import json

    import chip_smoke as cs

    card = cs.query_card()
    n, e, w, wp = 16 * 511, 768, 6283, 6288
    g = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn(n, e, generator=g, device=dev).to(torch.bfloat16)
    kc = (torch.randn(e, w, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    h32, kc32 = h.float(), kc.float()
    kp32 = torch.zeros(e, wp, device=dev)
    kp32[:, :w] = kc32
    ref = h32 @ kc32  # TF32 off: an f32 product of exact values

    def tf32(fn):
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            return fn()
        finally:
            torch.set_float32_matmul_precision(prev)

    modes = {"mm out_dtype float32":
             lambda: torch.mm(h, kc, out_dtype=torch.float32),
             "tf32, 6283 columns": lambda: tf32(lambda: h32 @ kc32),
             "tf32, padded to 6288": lambda: tf32(lambda: h32 @ kp32),
             "bf16 product": lambda: h @ kc}
    for name, fn in modes.items():
        err = float((fn()[:, :w].float() - ref).abs().max())
        ms = cs.cuda_ms(fn)
        _, _, top = cs._profiled(torch, fn)
        print(json.dumps({"mode": name, "ms": ms, "max_abs_err": err,
                          "kernels": [k[:60] for k, _ in top[:2]],
                          "card": card}), flush=True)


GLOO_OPS = ("all_reduce", "broadcast", "all_gather",
            "all_gather_into_tensor", "reduce_scatter_tensor",
            "all_to_all_single", "send_recv", "dtensor_full_tensor")


def _gloo_op(rank: int, port: int, name: str, out) -> None:
    """One rank of a two-rank gloo world on cuda:0 running ``name``; the
    answer goes to ``out`` (a process gloo aborts sends nothing)."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=20))
    dev = torch.device("cuda:0")
    x = torch.full((4, 3), float(rank + 1), device=dev)

    def run():
        if name == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return float(y[0, 0]) == 3.0
        if name == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return float(y[0, 0]) == 1.0
        if name == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            return float(parts[1][0, 0]) == 2.0
        if name == "all_gather_into_tensor":
            y = torch.empty((8, 3), device=dev)
            dist.all_gather_into_tensor(y, x)
            return float(y[4, 0]) == 2.0
        if name == "reduce_scatter_tensor":
            y = torch.empty((2, 3), device=dev)
            dist.reduce_scatter_tensor(y, x)
            return float(y[0, 0]) == 3.0
        if name == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return float(y[2, 0]) == 2.0
        if name == "send_recv":
            y = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank),
                   dist.P2POp(dist.irecv, y, 1 - rank)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return float(y[0, 0]) == float(2 - rank)
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = DeviceMesh("cuda", [0, 1])
        full = DTensor.from_local(x, mesh, [Shard(0)]).full_tensor()
        return tuple(full.shape) == (8, 3)

    try:
        ok = run()
        torch.cuda.synchronize()
        out.put((rank, "ok" if ok else "wrong values"))
    except Exception as exc:  # noqa: BLE001 — the probe's answer
        out.put((rank, f"{type(exc).__name__}: {str(exc)[:160]}"))
    dist.destroy_process_group()


def gloo_cuda(torch, dev) -> None:
    """Each op in a fresh two-rank world: what the ranks answer, or the
    exit code of a rank the backend aborted."""
    import json
    import multiprocessing as mp
    import queue
    import socket

    card = torch.cuda.get_device_name(dev)
    ctx = mp.get_context("spawn")
    for name in GLOO_OPS:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = ctx.Queue()
        procs = [ctx.Process(target=_gloo_op, args=(r, port, name, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, answer = out.get(timeout=60)
                got[rank] = answer
        except queue.Empty:
            pass
        finally:
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        print(json.dumps({"op": name, "answers": got,
                          "exit_codes": [p.exitcode for p in procs],
                          "card": card}), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe.py needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    commands = {"check": lambda: check(torch, dev, argv[1:]),
                "k5-accuracy": lambda: k5_accuracy(torch, dev),
                "k5-modes": lambda: k5_modes(torch, dev),
                "graph": lambda: graph(torch, dev),
                "trans-a": lambda: trans_a(torch, dev),
                "dw-accuracy": lambda: dw_accuracy(torch, dev),
                "dw-modes": lambda: dw_modes(torch, dev),
                "k4-accuracy": lambda: k4_accuracy(torch, dev),
                "k4-modes": lambda: k4_modes(torch, dev),
                "k5dx-accuracy": lambda: k5dx_accuracy(torch, dev),
                "k5dx-modes": lambda: k5dx_modes(torch, dev),
                "dkv-accuracy": lambda: _bwd_accuracy(torch, dev, "dkv"),
                "dq-accuracy": lambda: _bwd_accuracy(torch, dev, "dq"),
                "dkv-modes": lambda: dkv_modes(torch, dev),
                "paged-modes": lambda: paged_modes(torch, dev),
                "paged-accuracy": lambda: paged_accuracy(torch, dev),
                "serve-path": lambda: serve_path(torch, dev),
                "cublas-workspace": lambda: cublas_workspace(torch, dev),
                "int8-modes": lambda: int8_modes(torch, dev),
                "ce-modes": lambda: ce_modes(torch, dev),
                "p9-seeds": lambda: p9_seeds(
                    torch, dev, [int(a) for a in argv[1:]]),
                "flash-widths": lambda: flash_widths(torch, dev, argv[1:]),
                "ln-widths": lambda: ln_widths(
                    torch, dev, [int(a) for a in argv[1:]]),
                "gloo-cuda": lambda: gloo_cuda(torch, dev)}
    if not argv or argv[0] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    commands[argv[0]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
