#!/usr/bin/env python3
"""Short measurements of the port's kernels on one card, beside
``chip_smoke.py`` (whose helpers it uses): for the first calls after
editing a ``.cu`` file, and for the experiments PERF.md reports.

    python3 kernel_probe.py check check_flash [check_fused_conv3 ...]
        build the kernels, print the tensor-core kernels' ptxas lines,
        run chip_smoke's check functions by name;
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
        the sums over a step's 36 calls.

Each exits non-zero without a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def check(torch, dev, names) -> None:
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import kernels

    kernels.library()
    for fn, info in cs.ptxas_report(kernels.build_log).items():
        if "wgmma" in fn:
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


def _k4_ptxas() -> None:
    """Build the kernels and print ptxas's registers and spills of the
    bf16 K4f and K4dx kernels (none where this process found the
    library built)."""
    import chip_smoke as cs
    from pyspark_tf_gke_tpu_torch.ops import kernels

    kernels.library()
    for fn, info in cs.ptxas_report(kernels.build_log).items():
        if "k4_fwd_wgmma" in fn or "k4_dx_wgmma" in fn:
            print(f"ptxas {fn[fn.index('k4_'):][:40]}: {info['used']}; spill "
                  f"{info['spill_stores']}/{info['spill_loads']} B", flush=True)


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

    _k4_ptxas()
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

    _k4_ptxas()
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
                "k4-modes": lambda: k4_modes(torch, dev)}
    if not argv or argv[0] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    commands[argv[0]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
