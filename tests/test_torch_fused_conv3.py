"""PyTorch port, the fused 3x3 conv (K5f forward, K5dx and K5dw
backward, through the plain versions the wrappers take for CPU tensors)
on the CPU against the JAX ``conv3_norm_stats`` (its Pallas kernels in
interpret mode, as ``tests/test_fused_resnet.py`` runs them): the same
numpy-seeded inputs, the outputs, and the gradients in x, w, a and b of
``sum(y*cy) + sum(s*cs) + sum(ss*css)`` (the statistics terms only with
``want_stats``).

Tolerances, relative to the largest element of the reference:
* f32: 1e-5 for every output and gradient — both sides compute the same
  f32 products and sum them in another order (sums of <= 9 x 4 terms
  for y and dx, <= 72 for dw and the statistics);
* bf16: one bf16 rounding (8e-3) of y, dx and dw, and 2e-3 for the f32
  statistics and d a, d b (sums of values that may sit one bf16
  rounding apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pyspark_tf_gke_tpu.ops.pallas import fused_conv3 as jfc
from pyspark_tf_gke_tpu_torch.ops import fused_conv3 as tfc
from pyspark_tf_gke_tpu_torch.ops import fused_matmul as tfm

torch.set_num_threads(1)

# (x shape [B, H, W, K], N): an even and an odd one (H != W, K and N
# below every tile)
SHAPES = (((2, 6, 6, 4), 5), ((1, 7, 5, 3), 4))


def _close(got, want, rel, what=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    k = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, k, n)) / np.sqrt(9 * k)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=k).astype(np.float32)
    b = (rng.normal(size=k) * 0.5).astype(np.float32)
    cy = rng.normal(size=shape[:3] + (n,)).astype(np.float32)
    cs = rng.normal(size=n).astype(np.float32)
    css = (rng.normal(size=n) * 0.1).astype(np.float32)
    return x, w, a, b, cy, cs, css


def _jax_op(x, w, a, b, cy, cs, css, transform, relu, want_stats, dtype):
    def f(x, w, a, b):
        out = jfc.conv3_norm_stats(
            x, w, a if transform else None, b if transform else None,
            relu=relu, want_stats=want_stats, interpret=True)
        if want_stats:
            y, s, ss = out
            return (y * cy).sum() + (s * cs).sum() + (ss * css).sum(), out
        return (out * cy).sum(), (out,)

    args = (jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(a),
            jnp.asarray(b))
    argnums = (0, 1, 2, 3) if transform else (0, 1)
    (_, outs), grads = jax.jit(jax.value_and_grad(
        f, argnums=argnums, has_aux=True))(*args)
    return ([np.asarray(o.astype(jnp.float32)) for o in outs],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_op(x, w, a, b, cy, cs, css, transform, relu, want_stats, dtype):
    tx = torch.tensor(x).to(dtype).requires_grad_()
    tw = torch.tensor(w).to(dtype).requires_grad_()
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = tfc.conv3_norm_stats(tx, tw, ta if transform else None,
                               tb if transform else None, relu=relu,
                               want_stats=want_stats)
    outs = out if want_stats else (out,)
    loss = (outs[0] * torch.tensor(cy)).sum()
    if want_stats:
        loss = (loss + (outs[1] * torch.tensor(cs)).sum()
                + (outs[2] * torch.tensor(css)).sum())
    wrt = (tx, tw, ta, tb) if transform else (tx, tw)
    grads = torch.autograd.grad(loss, wrt)
    return ([o.detach().float().numpy() for o in outs],
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("shape,n", SHAPES)
@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("mode", ["none", "affine", "relu"])
def test_conv3_norm_stats_matches_jax_f32(mode, want_stats, shape, n):
    inputs = _inputs(shape, n, seed=60)
    kw = dict(transform=mode != "none", relu=mode == "relu",
              want_stats=want_stats)
    jouts, jgrads = _jax_op(*inputs, dtype=jnp.float32, **kw)
    touts, tgrads = _port_op(*inputs, dtype=torch.float32, **kw)
    assert len(touts) == len(jouts) and len(tgrads) == len(jgrads)
    for name, got, want in zip(("y", "sum", "sumsq"), touts, jouts):
        _close(got, want, 1e-5, name)
    for name, got, want in zip(("dx", "dw", "da", "db"), tgrads, jgrads):
        _close(got, want, 1e-5, name)


@pytest.mark.parametrize("shape,n", SHAPES)
def test_conv3_norm_stats_matches_jax_bf16(shape, n):
    inputs = _inputs(shape, n, seed=61)
    kw = dict(transform=True, relu=True, want_stats=True)
    jouts, jgrads = _jax_op(*inputs, dtype=jnp.bfloat16, **kw)
    touts, tgrads = _port_op(*inputs, dtype=torch.bfloat16, **kw)
    for name, got, want, rel in zip(("y", "sum", "sumsq"), touts, jouts,
                                    (8e-3, 2e-3, 2e-3)):
        _close(got, want, rel, name)
    for name, got, want, rel in zip(("dx", "dw", "da", "db"), tgrads,
                                    jgrads, (8e-3, 8e-3, 2e-3, 2e-3)):
        _close(got, want, rel, name)


def test_hand_backward_equals_autograd_through_the_plain_forward():
    """The hand-written backward (K5dx + K5dw through their plain
    versions on the CPU) equals autograd through K5f's plain forward,
    and ``conv3_norm_stats_plain`` (the plain versions on any device)
    equals the wrapper on the CPU bit for bit."""
    x, w, a, b, cy, cs, css = (torch.tensor(t) for t in _inputs(
        (2, 5, 7, 6), 9, seed=62))

    def autograd_plain(x, w, a, b, relu, want_stats):
        y, stats = tfc.conv3_fwd_plain(x, w, a, b, relu, want_stats)
        return y, stats[0], stats[1]

    res = []
    for fn in (tfc.conv3_norm_stats, tfc.conv3_norm_stats_plain,
               autograd_plain):
        p = [t.clone().requires_grad_() for t in (x, w, a, b)]
        y, s, ss = (fn(*p, True, True) if fn is autograd_plain
                    else fn(*p, relu=True, want_stats=True))
        loss = (y * cy).sum() + (s * cs).sum() + (ss * css).sum()
        res.append((y, s, ss) + torch.autograd.grad(loss, p))
    for got, same, want in zip(*res):
        assert torch.equal(got, same)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_plain_versions_are_the_padded_conv():
    """An independent f64 reference at a ragged shape (tiles of 128
    pixels cross rows and images on the card): ``F.conv2d`` with
    ``padding=1`` on the normalised input (the pad is zero AFTER the
    transform) and its autograd gradients, against the three plain
    versions (f32); the relu mask and d a, d b by the chain rule."""
    x, w, a, b, _, _, _ = (torch.tensor(t) for t in _inputs((3, 9, 5, 7), 6,
                                                            seed=63))
    dy = torch.randn(3, 9, 5, 6, generator=torch.Generator().manual_seed(0))
    xr, wr, ar, br = (t.double().requires_grad_() for t in (x, w, a, b))
    xn = torch.relu(xr * ar + br)
    ref = F.conv2d(xn.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    grads = torch.autograd.grad(ref, (xr, wr, ar, br), dy.double())
    gx, gw, ga, gb = (g.float() for g in grads)
    tol = dict(rtol=1e-5, atol=1e-5)
    y, stats = tfc.conv3_fwd_plain(x, w, a, b, True, True)
    torch.testing.assert_close(y, ref.detach().float(), **tol)
    torch.testing.assert_close(stats, torch.stack(
        [y.reshape(-1, 6).sum(0), (y * y).reshape(-1, 6).sum(0)]))
    dx, dstats = tfc.conv3_dx_plain(dy, w, x, a, b, True)
    torch.testing.assert_close(dx, gx, **tol)
    torch.testing.assert_close(dstats, torch.stack([ga, gb]), **tol)
    torch.testing.assert_close(tfc.conv3_dw_plain(x, dy, a, b, True), gw,
                               **tol)


def test_k5_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: a
    meta tensor (no card needed) is refused; a lone half of the
    transform, a kernel that is not 3x3 and mismatched dtypes raise on
    any device."""
    x = torch.empty(2, 5, 5, 3, device="meta")
    w = torch.empty(3, 3, 3, 4, device="meta")
    a = torch.empty(3, device="meta")
    dy = torch.empty(2, 5, 5, 4, device="meta")
    for call in (lambda: tfc.conv3_fwd(x, w, a, a, True, True),
                 lambda: tfc.conv3_dx(dy, w, x, a, a, True),
                 lambda: tfc.conv3_dw(x, dy, None, None, False)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="together"):
        tfc.conv3_fwd(x, w, a, None, True, False)
    xc, wc = torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 2)
    with pytest.raises(ValueError, match="together"):
        tfc.conv3_norm_stats(xc, wc, torch.ones(3))
    with pytest.raises(ValueError, match="3x3"):
        tfc.conv3_norm_stats(xc, torch.zeros(1, 1, 3, 2))
    with pytest.raises(ValueError, match="one dtype"):
        tfc.conv3_norm_stats(xc, wc.to(torch.bfloat16))


def test_dw_splits_give_enough_blocks_per_tap():
    """K5dw's grid is 9 taps x the K x N tiles x the splits: ResNet-50's
    stage 1 (9 tiles) splits its 200,704 pixels, stage 4 (288 tiles)
    hardly; every split is a whole number of 16-pixel steps."""
    got = {}
    for m, k in ((200704, 64), (50176, 128), (12544, 256), (3136, 512),
                 (45, 3)):
        splits, chunk = tfm.dw_splits(m, k, k, tfc.TAPS)
        assert chunk % tfm.BLOCK_K == 0 and chunk > 0
        assert (splits - 1) * chunk < m <= splits * chunk
        assert 9 * splits <= 65535
        got[k] = splits
    assert got[64] > 50 and got[512] <= 2 and got[3] == 1


# ResNet-50's stride-1 3x3 convs at batch 64 as (M pixels, N channels),
# and the ragged chip check shape ([3, 9, 5, 48] -> 80)
K5F_SHAPES = ((200704, 64), (50176, 128), (12544, 256), (3136, 512), (135, 80))


def _cu_constant(text: str, name: str) -> int:
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("m,n", K5F_SHAPES)
def test_k5f_partials_follow_its_own_tile_plan(m, n):
    """K5f sizes its [tiles, 2, N] statistics partials by its own tile
    plan, which is the tile of each kernel in csrc: bf16 runs the
    tensor-core kernel, 128 x 64 (wg::kBM x kBN) up to N = 64 and 64 x 128
    (wg::kWideBM x kWideBN) beyond; f32 the CUDA-core kernel, 128 x 64
    (tile_gemm.cuh's kBM x kBN)."""
    from pathlib import Path

    csrc = Path(tfc.__file__).resolve().parent.parent / "csrc"
    conv3 = (csrc / "fused_conv3.cu").read_text()
    wg = conv3[conv3.index("namespace wg {"):]
    simt = (csrc / "tile_gemm.cuh").read_text()
    assert (_cu_constant(wg, "kBM"), _cu_constant(wg, "kBN")) == tfc.K5F_TILE
    assert (_cu_constant(wg, "kWideBM"),
            _cu_constant(wg, "kWideBN")) == tfc.K5F_WIDE_TILE
    assert (_cu_constant(simt, "kBM"),
            _cu_constant(simt, "kBN")) == tfc.K5F_TILE
    for dtype in (torch.bfloat16, torch.float32):
        bm, bn, tiles_m, tiles_n = tfc.k5f_plan(m, n, dtype)
        want = (tfc.K5F_WIDE_TILE if dtype == torch.bfloat16 and n > 64
                else tfc.K5F_TILE)
        assert (bm, bn) == want
        assert (tiles_m - 1) * bm < m <= tiles_m * bm
        assert (tiles_n - 1) * bn < n <= tiles_n * bn


@pytest.mark.parametrize("m,n", K5F_SHAPES)
def test_bf16_k5dw_plan_covers_the_pixels_in_whole_steps(m, n):
    """bf16 K5dw's plan: 64 x 64 tiles (no half-empty tile at K = 64),
    the pixels in whole 64-pixel steps, every split non-empty, a grid of
    3 kernel rows x tiles x splits that fills the H100's 132 SMs at every
    ResNet-50 stage; f32 keeps ``dw_splits(taps=9)``."""
    tk, tn, splits, chunk = tfm.dw_plan(m, n, n, torch.bfloat16, tfc.TAPS)
    assert (tk, tn) == (tfm.DW_WG_TILE, tfm.DW_WG_TILE)
    assert chunk % tfm.DW_STEP == 0
    assert (splits - 1) * chunk < m <= splits * chunk
    ctas = 3 * -(-n // tk) * -(-n // tn) * splits
    assert ctas <= 2 ** 31 - 1
    if m >= 3136:
        assert ctas >= 132
    assert tfm.dw_plan(m, n, n, torch.float32, tfc.TAPS) == (
        tfm.BLOCK_M, tfm.BLOCK_N) + tfm.dw_splits(m, n, n, tfc.TAPS)


@pytest.mark.parametrize("source", ["fused_matmul.cu", "fused_conv3.cu"])
def test_bf16_dw_constants_match_the_kernels(source):
    """The bf16 dw plan's constants are the kernels': a warpgroup's dw
    tile (each source's ``wgdw::kTile``), the pixels a step
    (``wgmma_dw.cuh``), and the CTAs an SM holds (K4dw's launch bounds,
    ``wgdw::kResident1, 2, 4``: 3, 2, 1 for 1, 2, 4 warpgroups; K5dw:
    384 threads, one a SM)."""
    from pathlib import Path

    csrc = Path(tfc.__file__).resolve().parent.parent / "csrc"
    text = (csrc / source).read_text()
    wgdw = text[text.index("namespace wgdw {"):]
    assert _cu_constant(wgdw, "kTile") == tfm.DW_WG_TILE
    header = (csrc / "wgmma_dw.cuh").read_text()
    assert _cu_constant(header, "kPix") == tfm.DW_STEP
    if source == "fused_conv3.cu":
        assert _cu_constant(wgdw, "kThreads") == 384
        assert tfm.DW_RESIDENT[3] == 1
    else:
        for wgs in (1, 2, 4):
            assert _cu_constant(wgdw, f"kResident{wgs}") == tfm.DW_RESIDENT[wgs]
        assert (tfm.DW_RESIDENT[1], tfm.DW_RESIDENT[2],
                tfm.DW_RESIDENT[4]) == (3, 2, 1)


@pytest.mark.parametrize("m,n", K5F_SHAPES[:4])
def test_k5f_plan_fills_the_h100(m, n):
    """At every ResNet-50 stage shape bf16 K5f launches at least one CTA
    for each of an H100's 132 SMs (stage 4: 49 x 4 = 196)."""
    _, _, tiles_m, tiles_n = tfc.k5f_plan(m, n, torch.bfloat16)
    assert tiles_m * tiles_n >= 132


# K5dx's shapes (B, H, W, K): ResNet-50's four stride-1 stages at batch
# 64, the ragged chip check shape, one wider than a tile (W > 128) and
# one whose images are smaller than a tile
K5DX_SHAPES = ((64, 56, 56, 64), (64, 28, 28, 128), (64, 14, 14, 256),
               (64, 7, 7, 512), (3, 9, 5, 48), (2, 3, 200, 16),
               (5, 2, 3, 8))


def _k5dx_block_n(k: int) -> int:
    """bf16 K5dx's output tile width along K (csrc/fused_conv3.cu
    wgdx::run)."""
    return 64 if k <= 64 else 128


@pytest.mark.parametrize("shape", K5DX_SHAPES)
def test_k5dx_partials_follow_its_own_tile_plan(shape, monkeypatch):
    """bf16 K5dx's pixel tile is whole image rows of at most wgdx::kBM
    pixels (csrc/fused_conv3.cu), so that one 4-D TMA box brings a
    tap-shifted tile; the tiles cover every pixel exactly once; the
    wrapper sizes the [tiles, 2, K] d a / d b partials by the plan and
    hands the kernel the same tile (f32: tiles of fused_matmul.BLOCK_M
    flattened pixels, the CUDA-core kernel's)."""
    from pathlib import Path

    bsz, h, wd, k = shape
    csrc = Path(tfc.__file__).resolve().parent.parent / "csrc"
    conv3 = (csrc / "fused_conv3.cu").read_text()
    wgdx = conv3[conv3.index("namespace wgdx {"):]
    assert _cu_constant(wgdx, "kBM") == tfc.K5DX_PIXELS
    assert "const int bn = kdim <= 64 ? 64 : 128;" in wgdx
    (nb, rows, wc), tiles = tfc.k5dx_plan(bsz, h, wd, torch.bfloat16)
    assert nb * rows * wc <= tfc.K5DX_PIXELS
    assert (nb == 1 or rows == h) and (rows == 1 or wc == wd)
    seen = torch.zeros(bsz, h, wd, dtype=torch.int32)
    tb, ti, tj = -(-bsz // nb), -(-h // rows), -(-wd // wc)
    assert tb * ti * tj == tiles
    for pt in range(tiles):  # wgdx::origin
        b0, i0, j0 = (pt // (ti * tj)) * nb, (pt // tj % ti) * rows, \
            (pt % tj) * wc
        seen[b0:b0 + nb, i0:i0 + rows, j0:j0 + wc] += 1
    assert bool((seen == 1).all())
    if wd <= 64:  # a tile of more than one row when rows fit
        assert nb * rows * wc > tfc.K5DX_PIXELS // 2 or nb * rows == bsz * h
    assert tfc.k5dx_plan(bsz, h, wd, torch.float32) == (
        (1, 1, tfm.BLOCK_M), -(-bsz * h * wd // tfm.BLOCK_M))

    # the wrapper allocates the partials of that many tiles and passes the
    # tile after the transform code
    calls = []

    class FakeLibrary:
        def port_k5_dx(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tfc.kernels, "require_cuda",
                        lambda kernel, *ts: ts[0].device)
    monkeypatch.setattr(tfc.kernels, "library", FakeLibrary)
    monkeypatch.setattr(tfc.kernels, "launch_args", lambda device: (0, 0))
    made = []
    real_empty = torch.empty
    monkeypatch.setattr(tfc.torch, "empty", lambda *a, **kw: made.append(
        tuple(a[0]) if a and isinstance(a[0], tuple) else None) or
        real_empty(*a, **kw))
    for dtype in (torch.bfloat16, torch.float32):
        made.clear()
        calls.clear()
        tile, want = tfc.k5dx_plan(bsz, h, wd, dtype)
        x = torch.empty(bsz, h, wd, k, device="meta", dtype=dtype)
        w = torch.empty(3, 3, k, 24, device="meta", dtype=dtype)
        dy = torch.empty(bsz, h, wd, 24, device="meta", dtype=dtype)
        a = torch.empty(k, device="meta")
        tfc.conv3_dx(dy, w, x, a, a, True)
        assert (want, 2, k) in made, made
        assert calls[0][8:17] == (bsz, h, wd, k, 24, 2, *tile)


@pytest.mark.parametrize("shape", K5DX_SHAPES[:4])
def test_k5dx_plan_fills_the_h100(shape):
    """At every ResNet-50 stage shape bf16 K5dx's output tiles fill at
    least 128 of an H100's 132 SMs (its persistent grid is one CTA an
    SM; stage 4's 32 pixel tiles of two 7x7 images x 4 channel tiles are
    one wave of 128), and its whole-row tiles use at least 3/4 of their
    128 rows."""
    bsz, h, wd, k = shape
    (nb, rows, wc), tiles = tfc.k5dx_plan(bsz, h, wd, torch.bfloat16)
    assert tiles * -(-k // _k5dx_block_n(k)) >= 128
    assert bsz * h * wd >= 0.75 * tiles * tfc.K5DX_PIXELS
