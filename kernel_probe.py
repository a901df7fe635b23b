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
        K2f, SDPA and K5f eager and replayed from a CUDA graph.

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
                "graph": lambda: graph(torch, dev)}
    if not argv or argv[0] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    commands[argv[0]]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
