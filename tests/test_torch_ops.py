"""PyTorch port, kernel modules: the plain versions the kernel wrappers
take on CPU tensors, held against the JAX package's kernels run as its
own tests run them (Pallas ``interpret=True``) on the same numpy inputs.

Tolerances (f32 on the CPU, where the point is the algorithm): 2e-5
absolute for the ops — both sides compute in f32, the differences are
summation order and exp/rsqrt rounding, a few ulps of O(1) values.
The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash)
from pyspark_tf_gke_tpu.ops.pallas.layernorm import (
    fused_layernorm as jax_layernorm)
from pyspark_tf_gke_tpu.ops.pallas.paged_attention import (
    paged_attention_chunk as jax_paged_chunk)
from pyspark_tf_gke_tpu_torch.ops import flash_attention as t_flash
from pyspark_tf_gke_tpu_torch.ops import paged_attention as t_paged
from pyspark_tf_gke_tpu_torch.ops.attention import dot_product_attention
from pyspark_tf_gke_tpu_torch.ops.layernorm import fused_layernorm
from pyspark_tf_gke_tpu_torch.ops.quant import quantize_tree

torch.set_num_threads(1)

OP_ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- K3 LayerNorm -------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("d", [32, 1280, 4096])
def test_layernorm_matches_jax_kernel(residual, d):
    """Widths: 32, GPT-2 large's 1280 and 4096 (the kernels' wide
    variant on the card; the JAX kernel takes any D)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, d)).astype(np.float32) * 3 + 1
    r = rng.standard_normal((2, 8, d)).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ref = jax_layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                        eps=1e-5, interpret=True,
                        residual=jnp.asarray(r) if residual else None)
    out = fused_layernorm(_t(x), _t(scale), _t(bias), eps=1e-5,
                          residual=_t(r) if residual else None)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


def _cu_ints(path, *names):
    import re
    from pathlib import Path

    text = (Path(t_flash.__file__).resolve().parent.parent / "csrc"
            / path).read_text()
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


def test_ln_plan_takes_every_width_and_fits_the_kernels():
    """``ln_plan`` gives every D from 1 to 8192, bf16 and f32, aligned or
    not, a launch shape the kernels (csrc/layernorm*.cu, whose constants
    are read from the source) take and that fits their registers and
    shared memory; 0 and 8193 raise. Up to 1024 K3 keeps its first
    design's warp a row (32 values a lane). Beyond, K3 takes 16-byte
    chunks where D allows and the pointers are aligned, else scalar
    loads; a row belongs to the fewest threads that hold at most 4
    chunks or 8 values each; a thread keeps its row slice in f32, the
    raw loads of x and r, and one chunk's scale and bias in registers,
    within the register file's share of its CTA. K3b takes that rule at
    every D with at most 3 chunks a thread in bf16 (a warp a row up to
    768), its values a thread sized by D: the raw loads of x and g and
    two f32 column sums a value, within 128 registers (64 scalar); a CTA
    holding several rows keeps its partial row in at most 48 KB of
    shared memory."""
    from pyspark_tf_gke_tpu_torch.ops import layernorm as t_ln

    warps, per_lane, cta, vec_per, scalar_per, max_d = _cu_ints(
        "layernorm.cu", "kWarps", "kMaxPerLane", "kCtaThreads", "kMaxVecPer",
        "kScalarPer", "kMaxD")
    (bwd_cta, bwd_chunks_bf16, bwd_chunks_f32, bwd_scalar_per, bwd_max_d,
     max_blocks) = _cu_ints("layernorm_bwd.cu", "kCtaThreads",
                            "kMaxChunksBf16", "kMaxChunksF32", "kScalarPer",
                            "kMaxD", "kMaxBlocks")
    assert max_d == bwd_max_d == t_ln.MAX_D == 8192
    assert (cta, vec_per, scalar_per) == (t_ln.CTA_THREADS, t_ln.MAX_VEC_PER,
                                          t_ln.SCALAR_PER)
    assert (bwd_cta, bwd_scalar_per, max_blocks) == (
        t_ln.BWD_CTA_THREADS, t_ln.BWD_SCALAR_PER, t_ln.BWD_MAX_BLOCKS)
    assert t_ln.BWD_MAX_CHUNKS == {2: bwd_chunks_bf16, 4: bwd_chunks_f32}
    narrow = 32 * per_lane
    assert narrow == t_ln.NARROW_D
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        chunk = 16 // size
        for aligned in (True, False):
            for d in range(1, max_d + 1):
                p = t_ln.ln_plan(d, dtype, aligned)
                # K3b, every width
                vec = p.bwd_vec
                assert vec == (chunk if aligned and d % chunk == 0 else 1)
                most = (t_ln.BWD_MAX_CHUNKS[size] if vec > 1
                        else bwd_scalar_per)
                n = -(-d // vec)
                rt = p.bwd_row_threads
                assert rt >= 32 and rt & (rt - 1) == 0
                assert rt * most >= n and (rt == 32 or rt * most // 2 < n)
                if vec > 1:
                    assert p.bwd_per <= most
                    assert p.bwd_per * rt >= n > (p.bwd_per - 1) * rt
                else:
                    assert p.bwd_per == bwd_scalar_per
                assert p.bwd_threads == max(rt, bwd_cta)
                assert p.bwd_threads <= (1024 if vec == 1 else 512)
                if d <= 768 and dtype == torch.bfloat16 and vec > 1:
                    assert rt == 32  # a warp a row: shuffles only
                # registers: x and g as loaded, two f32 column sums a
                # value, within the 128 a thread of a 512-thread CTA has
                values = p.bwd_per * vec * (2 * size / 4 + 2)
                assert values + 24 <= (64 if vec == 1 else 128), (d, p)
                if p.bwd_threads > rt:
                    assert 2 * 4 * d <= 48 * 1024
                # K3
                if d <= narrow:
                    assert p[:4] == (1, per_lane, 32, warps * 32)
                    continue
                assert p.vec == (chunk if aligned and d % chunk == 0 else 1)
                most = vec_per if p.vec > 1 else scalar_per
                n = -(-d // p.vec)
                rt = p.row_threads
                assert rt >= 64 and rt & (rt - 1) == 0
                assert p.per <= most and p.per * rt >= n > most * rt // 2
                assert p.threads == max(rt, cta) <= 1024
                # registers: the f32 row slice, the raw loads of x and r,
                # a chunk's scale and bias, within 255 and the CTA's share
                values = p.per * p.vec * (1 + 2 * size / 4) + 2 * p.vec
                assert values + 24 <= min(255, 65536 // p.threads), (d, p)
    for d in (0, max_d + 1):
        with pytest.raises(ValueError, match="8192"):
            t_ln.ln_plan(d, torch.bfloat16)


def test_layernorm_keeps_input_dtype():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    out = fused_layernorm(x.to(torch.bfloat16), torch.ones(32),
                          torch.zeros(32))
    assert out.dtype == torch.bfloat16


# -- K2 forward: flash attention ----------------------------------------------


def _np_lse(q, k, keep):
    """numpy logsumexp of the masked scores, +inf on rows with no key."""
    d = q.shape[-1]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * d ** -0.5
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        out = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    return np.where(keep.any(-1), out, np.inf)


FLASH_CASES = ["causal", "kv_mask", "segments", "masked_row", "all"]


@pytest.mark.parametrize(
    "case,d", [pytest.param(c, 8, id=c) for c in FLASH_CASES]
    + [pytest.param(c, d, id=f"{c}-d{d}") for d in (16, 80, 128)
       for c in FLASH_CASES])
def test_flash_matches_jax_kernel(case, d):
    """Every head width runs the same plain version: 8, and 16, 80 and
    128 (a CUDA-core width, one between two instantiations, and the
    second tensor-core width on the card)."""
    rng = np.random.default_rng(1)
    b, s, h = 2, 16, 2
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    causal = case in ("causal", "all")
    kv_mask = segs = None
    keep = np.ones((b, h, s, s), bool)
    if causal:
        keep &= np.tril(np.ones((s, s), bool))[None, None]
    if case in ("kv_mask", "masked_row", "all"):
        kv_mask = rng.random((b, s)) > 0.3
        if case == "masked_row":
            kv_mask[1] = False  # every key of batch row 1 masked
        if case == "all":
            # the first key of the second segment is padding: that query
            # row's only unmasked keys lie in its future -> an empty row
            kv_mask[:, 4] = False
            kv_mask[:, 5] = True
        keep &= kv_mask[:, None, None, :]
    if case in ("segments", "all"):
        segs = np.repeat(np.arange(4), 4)[None].repeat(b, 0).astype(np.int32)
        keep &= (segs[:, None, :, None] == segs[:, None, None, :])
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
                    causal=causal,
                    segment_ids=None if segs is None else jnp.asarray(segs),
                    interpret=True)
    out, lse = t_flash.flash_attention_fwd(
        _t(q), _t(k), _t(v),
        kv_mask=None if kv_mask is None else _t(kv_mask),
        causal=causal, segment_ids=None if segs is None else _t(segs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, keep),
                               atol=1e-5, rtol=1e-5)
    if case == "masked_row":
        assert np.all(out.numpy()[1] == 0.0)
        assert np.all(np.isposinf(lse.numpy()[1]))


def _c_plan_width(d: int, code: int) -> int:
    """``csrc/flash_attention.cuh plan_width``: the width the C entry
    points accept for (head_dim, dtype code), 0 outside their limits."""
    if not 1 <= d <= 256 or code not in (0, 1):
        return 0
    if code == 1 and d in (64, 128):
        return d
    w = 16
    while w < d:
        w *= 2
    return w


def test_flash_plan_takes_every_head_width(monkeypatch):
    """Every head width 1..256 has a kernel in bf16 and f32: bf16 at 64
    and 128 on the tensor cores at that width, every other (width,
    dtype) on the CUDA cores at the next instantiated width; 257 raises
    naming the limit. The kernel library is replaced by one that checks
    what the C entry points check (the plan's width, recomputed from D
    and the dtype; no card here): the wrappers hand K2dq and K2dkv the
    plan's width at every D, and only the tensor-core widths require
    TMA-addressable q/k/v (bf16 D = 12 has a head stride of 12, which
    TMA cannot address, and runs)."""
    simt = {1: 16, 8: 16, 12: 16, 16: 16, 32: 32, 64: 64, 80: 128, 96: 128,
            128: 128, 200: 256, 256: 256}
    for d, width in simt.items():
        for dtype in (torch.bfloat16, torch.float32):
            plan = t_flash.flash_plan(d, dtype)
            if dtype == torch.bfloat16 and d in (64, 128):
                assert plan == ("wgmma", d)
            else:
                assert plan == ("simt", width)
            code = 1 if dtype == torch.bfloat16 else 0
            assert _c_plan_width(d, code) == plan.width
    for bad in (0, 257):
        with pytest.raises(ValueError, match="256"):
            t_flash.flash_plan(bad, torch.float32)

    calls = []

    class FakeLibrary:
        @staticmethod
        def _entry(name, args, n_ptrs):
            d, code, width = args[n_ptrs + 3], args[-4], args[-3]
            calls.append((name, d, code, width))
            w = _c_plan_width(d, code)
            return 0 if w and w == width else 1  # cudaErrorInvalidValue

        def port_flash_attention_dq(self, *args):
            return self._entry("dq", args, 9)

        def port_flash_attention_dkv(self, *args):
            return self._entry("dkv", args, 10)

    monkeypatch.setattr(t_flash.kernels, "require_cuda",
                        lambda kernel, *ts: ts[0].device)
    monkeypatch.setattr(t_flash.kernels, "library", FakeLibrary)
    monkeypatch.setattr(t_flash.kernels, "launch_args", lambda dev: (0, 0))
    b, s, h = 2, 8, 3
    lse, delta = (torch.zeros(b, h, s) for _ in range(2))
    for d in simt:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(b, s, h, d, dtype=dtype)
            calls.clear()
            t_flash.flash_attention_dq(q, q, q, q, lse, delta, causal=True)
            t_flash.flash_attention_dkv(q, q, q, q, lse, delta, causal=True)
            code = 1 if dtype == torch.bfloat16 else 0
            width = t_flash.flash_plan(d, dtype).width
            assert calls == [("dq", d, code, width), ("dkv", d, code, width)]
    # bf16 D 12: not TMA-addressable, and the CUDA-core design takes it
    # as it is (no copy of dout: its strides reach the kernel)
    q12 = torch.zeros(b, s, h, 12, dtype=torch.bfloat16)
    assert not t_flash.tma_compatible(q12)
    dout = torch.zeros(b, s, h, 16, dtype=torch.bfloat16)[..., :12]
    assert t_flash._bwd_dout(dout, q12) is dout
    t_flash.flash_attention_dkv(dout, q12, q12, q12, lse, delta)
    # a tensor-core width still requires TMA-addressable q/k/v
    for d in (64, 128):
        bad = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16)[..., :d]
        with pytest.raises(ValueError, match="TMA"):
            t_flash.flash_attention_dq(bad, bad, bad, bad, lse, delta)
    # a width the C entry points do not accept fails the launch
    monkeypatch.setattr(t_flash, "flash_plan",
                        lambda d, dtype: t_flash.FlashPlan("simt", 64))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        t_flash.flash_attention_dq(q12, q12, q12, q12, lse, delta)


def test_dot_product_attention_fully_masked_row_is_zero():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((1, 4, 2, 8)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    mask[..., 2, :] = False
    out = dot_product_attention(q, k, v, mask=mask)
    assert torch.all(out[0, 2] == 0)
    assert torch.all(out[0, 1] != 0)


# -- K1: paged attention -----------------------------------------------------


def _paged_inputs(rng, g, sq, quant):
    n, ps, hkv, d, b, mp = 12, 8, 2, 16, 6, 4
    h = hkv * g
    if quant:
        kp = rng.integers(-127, 128, (n, ps, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (n, ps, hkv, d)).astype(np.int8)
        ks = (rng.random((n, ps, hkv)) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.random((n, ps, hkv)) * 0.02 + 1e-3).astype(np.float32)
    else:
        kp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
        vp = rng.standard_normal((n, ps, hkv, d)).astype(np.float32)
        ks = vs = None
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    table = rng.integers(0, n, (b, mp)).astype(np.int32)
    table[0] = n           # fully unallocated row (sentinels)
    table[1, 2:] = n       # allocated prefix, sentinel tail
    # empty, one token, page boundary, partial last page, mid, full
    fills = np.asarray([0, max(1, sq), ps, ps + 3, 2 * ps + 5, mp * ps],
                       np.int32)
    return q, kp, vp, table, fills, ks, vs


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_matches_jax_kernel(g, sq, quant):
    rng = np.random.default_rng(10 + 4 * g + sq)
    q, kp, vp, table, fills, ks, vs = _paged_inputs(rng, g, sq, quant)
    jscales = ({} if ks is None else
               dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    ref = jax_paged_chunk(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(table), jnp.asarray(fills),
                          interpret=True, **jscales)
    tscales = ({} if ks is None else
               dict(k_scales=_t(ks), v_scales=_t(vs)))
    if sq == 1:
        out = t_paged.paged_attention(_t(q[:, 0]), _t(kp), _t(vp), _t(table),
                                      _t(fills), **tscales)[:, None]
    else:
        out = t_paged.paged_attention_chunk(_t(q), _t(kp), _t(vp), _t(table),
                                            _t(fills), **tscales)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    assert np.all(out.numpy()[0] == 0.0)  # empty slot: exact zeros


def test_paged_validation():
    kp = torch.zeros(4, 4, 2, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    fills = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide"):
        t_paged.paged_attention(torch.zeros(1, 3, 8), kp, kp, table, fills)
    with pytest.raises(ValueError, match="together"):
        t_paged.paged_attention(torch.zeros(1, 4, 8), kp, kp, table, fills,
                                k_scales=torch.ones(4, 4, 2))


def _split_merge_plain(q, kp, vp, table, fills, ks, vs, pages_per_split):
    """The decode variant's arithmetic in plain PyTorch (f32): each split
    of ``pages_per_split`` table entries runs its own online softmax over
    the live pages it holds (m, the unrounded l, and P V with p rounded
    to V's dtype; an empty split gives m = NEG_INF, l = 0), then the
    splits merge in split order, a row with no live key giving zeros."""
    n, ps, hkv, d = kp.shape
    b, sq, h, _ = q.shape
    g = h // hkv
    mp = table.shape[1]
    neg = t_paged.NEG_INF
    out = torch.zeros(b, sq, h, d)
    for slot in range(b):
        fill = int(fills[slot])
        live = min(-(-fill // ps) if fill > 0 else 0, mp)
        for hk in range(hkv):
            for r in range(sq * g):
                s_idx, gi = divmod(r, g)
                q_abs = fill - sq + s_idx
                qv = q[slot, s_idx, hk * g + gi].float()
                parts = []
                for j0 in range(0, mp, pages_per_split):
                    m, l, acc = neg, 0.0, torch.zeros(d)
                    for j in range(j0, min(j0 + pages_per_split, live)):
                        page = min(max(int(table[slot, j]), 0), n - 1)
                        k = kp[page, :, hk].float()
                        v = vp[page, :, hk].float()
                        if ks is not None:
                            k = (k * ks[page, :, hk, None]).to(q.dtype).float()
                            v = (v * vs[page, :, hk, None]).to(q.dtype).float()
                        sc = (k @ qv) * d ** -0.5
                        pos = j * ps + torch.arange(ps)
                        sc = torch.where(pos <= q_abs, sc,
                                         torch.tensor(neg))
                        m_new = max(m, float(sc.max()))
                        alpha = float(np.exp(np.float32(m - m_new)))
                        pr = torch.exp(sc - m_new)
                        l = l * alpha + float(pr.sum())
                        acc = acc * alpha + pr.to(q.dtype).float() @ v
                        m = m_new
                    parts.append((m, l, acc))
                big = max(m for m, _, _ in parts)
                tot_l, tot = 0.0, torch.zeros(d)
                for m, l, acc in parts:  # split order
                    if m > neg / 2:
                        f = float(np.exp(np.float32(m - big)))
                        tot_l += l * f
                        tot = tot + acc * f
                if big > neg / 2:
                    out[slot, s_idx, hk * g + gi] = tot / (tot_l or 1.0)
    return out.to(q.dtype)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_split_merge_matches_jax_kernel(g, sq, quant, pages_per_split):
    """The decode variant's split-then-merge (partials of
    ``pages_per_split`` table entries, merged in split order), emulated
    in plain PyTorch, against the JAX kernel (``interpret=True``) at the
    fills of ``_paged_inputs`` and, in the last three slots, fills on a
    split's boundary, one past it, and the whole table; the empty slot
    gives exact zeros."""
    rng = np.random.default_rng(40 + 4 * g + sq)
    q, kp, vp, table, fills, ks, vs = _paged_inputs(rng, g, sq, quant)
    ps, mp = kp.shape[1], table.shape[1]
    fills[3:] = [pages_per_split * ps, pages_per_split * ps + 1, mp * ps]
    jscales = ({} if ks is None else
               dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
    ref = jax_paged_chunk(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(table), jnp.asarray(fills),
                          interpret=True, **jscales)
    out = _split_merge_plain(_t(q), _t(kp), _t(vp), _t(table), _t(fills),
                             None if ks is None else _t(ks),
                             None if vs is None else _t(vs), pages_per_split)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    assert np.all(out.numpy()[0] == 0.0)  # empty slot: exact zeros


class _FakeKernelLibrary:
    """Stands in for the built kernel library: records the K1 launch's
    arguments and refuses what ``port_paged_attention`` refuses, variant
    by variant (``csrc/paged_attention.cu``): a decode plan whose splits
    do not cover the table, rows outside 1-8, a ring over its shared
    memory or no scratch for several splits; a chunk plan off its bf16
    query, 64-token pages, head_dim 64 and 128 rows; a first-design row
    block over the group's rows or its shared memory; more than 65535
    blocks."""

    def __init__(self):
        self.calls = []

    def port_paged_attention(self, *args):
        part = args[8]
        b, s, h, hkv, d, n, p, mp = args[9:17]
        variant, rows, splits, pps, stages = args[17:22]
        qcode, kvcode = args[23:25]
        r = s * (h // hkv)
        blocks = -(-r // rows)
        self.calls.append((s, rows, blocks, variant, splits, pps))
        if variant == t_paged.VARIANTS["decode"]:
            kv_size = 1 if kvcode == 2 else 4 if kvcode == 0 else 2
            ok = (d == 64 and p % 16 == 0 and pps > 0
                  and splits == -(-mp // pps) and splits * blocks <= 65535
                  and 1 <= stages <= 4 and rows in (1, 2, 4, 8)
                  and t_paged.decode_smem(rows, stages, kv_size) <= 232448
                  and (splits == 1 or part is not None))
        elif variant == t_paged.VARIANTS["chunk"]:
            ok = (qcode == 1 and d == 64 and p == 64 and rows == 128
                  and splits == 1 and pps == mp and stages == 2
                  and blocks <= 65535)
        else:
            smem = t_paged.smem_bytes(rows, d, p)
            ok = (0 < rows <= r and blocks <= 65535 and smem <= 232448
                  and splits == 1 and pps == mp and stages == 1)
        return 0 if ok else 1


def _fake_library(monkeypatch):
    from pyspark_tf_gke_tpu_torch.ops import kernels

    fake = _FakeKernelLibrary()
    monkeypatch.setattr(kernels, "library", lambda: fake)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(kernels, "launch_args", lambda device: (0, None))
    return fake


_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def _paged_pages(kv, n, p, hkv, d):
    dtype = _KV_DTYPES[kv]
    pages = torch.zeros(n, p, hkv, d, dtype=dtype)
    scales = ({} if kv != "int8" else
              dict(k_scales=torch.ones(n, p, hkv),
                   v_scales=torch.ones(n, p, hkv)))
    return pages, scales, torch.float32 if kv == "int8" else dtype


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g", [1, 3, 4, 12])
def test_paged_row_plan_takes_any_chunk(g, kv, monkeypatch):
    """K1's first-design row blocks (``row_plan``): every chunk width up
    to 2048 at P = D = 64 fits the 232,448 bytes of shared memory a
    block may use (the figure ``csrc/paged_attention.cu`` checks), in
    equal blocks that cover the group's rows; S <= 8 keeps one block of
    every row. Through the wrapper, with the launch recorded instead of
    run, no S — 256 at H = H_kv = 12, GPT-small's chunked-prefill piece,
    included — is refused, for f32, bf16 or int8 pages: S = 1 and 8 take
    the decode variant, wider chunks the chunk variant (bf16) or the
    first design, 128 rows a block at S = 256, G = 1 either way."""
    import re
    from pathlib import Path

    cu = (Path(t_paged.__file__).resolve().parent.parent / "csrc"
          / "paged_attention.cu").read_text()
    limit = int(re.search(r"constexpr long long kMaxSmem = (\d+);",
                          cu).group(1))
    assert limit == t_paged.MAX_SMEM == 232448
    h, hkv, d, p = 12, 12 // g, 64, 64
    widths = (1, 2, 8, 85, 86, 255, 256, 257, 512, 1000, 1024, 2048)
    for s in widths:
        r = s * g
        rows, blocks, smem = t_paged.row_plan(s, h, hkv, d, p)
        assert smem == t_paged.smem_bytes(rows, d, p) <= limit
        assert (blocks - 1) * rows < r <= blocks * rows
        old = 4 * (p * (d + 1) + p * d + r * (2 * d + p + 3))
        if s <= 8 or old <= limit:  # everything that launched before
            assert (rows, blocks, smem) == (r, 1, old)
        else:  # the fewest blocks: one block fewer would not fit
            assert t_paged.smem_bytes(-(-r // (blocks - 1)), d, p) > limit
    fake = _fake_library(monkeypatch)
    pages, scales, qdtype = _paged_pages(kv, 2, p, hkv, d)
    table = torch.zeros(1, 1, dtype=torch.int32)
    fills = torch.full((1,), 1, dtype=torch.int32)
    for s in (1, 8, 256, 2048):
        q = torch.zeros(1, s, h, d, dtype=qdtype)
        t_paged._launch(q, pages, pages, table, fills,
                        scales.get("k_scales"), scales.get("v_scales"))
    assert [c[0] for c in fake.calls] == [1, 8, 256, 2048]
    decode = t_paged.VARIANTS["decode"]
    assert [c[3] for c in fake.calls[:2]] == [decode, decode]
    wide = (t_paged.VARIANTS["chunk"] if qdtype == torch.bfloat16
            else t_paged.VARIANTS["rows"])
    assert [c[3] for c in fake.calls[2:]] == [wide, wide]
    if g == 1:
        assert fake.calls[2][:3] == (256, 128, 2)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g", [1, 3, 4, 12])
def test_paged_plan_splits_the_table_and_takes_decode_for_small_chunks(
        g, kv, monkeypatch):
    """``paged_plan`` is a function of the shape and dtypes alone (no
    fills, no card): the same shape gives the same plan. Its decode
    splits cover every table entry exactly once, in at most 65535 CTAs
    along the grid's z axis, and reach the target CTA count where the
    table has the pages for it; every decode step and every chunk of S
    <= 8 takes the decode variant, wider chunks the chunk variant for a
    bf16 query (rows in 128-row blocks) and the first design otherwise.
    Every plan for S up to 2048 and tables of 1 to 5000 entries launches
    through the wrapper (the launch recorded, as the kernel checks it)."""
    fake = _fake_library(monkeypatch)
    h, hkv, d, p = 12, 12 // g, 64, 64
    pages, scales, qdtype = _paged_pages(kv, 4, p, hkv, d)
    decode = t_paged.VARIANTS["decode"]
    for b in (1, 8, 64):
        for mp in (1, 3, 16, 100, 5000):
            for s in (1, 2, 4, 8, 9, 16, 17, 64, 256, 512, 2048):
                plan = t_paged.paged_plan(b, s, h, hkv, d, p, mp, qdtype,
                                          pages.dtype)
                assert plan == t_paged.paged_plan(b, s, h, hkv, d, p, mp,
                                                  qdtype, pages.dtype)
                r = s * g
                assert (plan.blocks - 1) * plan.rows < r <= (plan.blocks
                                                             * plan.rows)
                if s <= 8:
                    assert plan.variant == "decode"
                if plan.variant == "decode":
                    assert s <= 8
                    covered = [j for z in range(plan.splits)
                               for j in range(z * plan.pages_per_split,
                                              min((z + 1)
                                                  * plan.pages_per_split,
                                                  mp))]
                    assert covered == list(range(mp))
                    assert plan.splits * plan.blocks <= 65535
                    ctas = b * hkv * plan.blocks * plan.splits
                    assert (ctas >= t_paged.DECODE_TARGET_CTAS
                            or plan.splits == mp
                            or plan.splits * plan.blocks > 65535 // 2)
                    assert plan.smem == t_paged.decode_smem(
                        plan.rows, plan.stages, pages.element_size())
                elif qdtype == torch.bfloat16:
                    assert plan.variant == "chunk" and plan.rows == 128
                else:
                    assert plan.variant == "rows"
                if b == 8 and mp == 16:
                    table = torch.zeros(b, mp, dtype=torch.int32)
                    fills = torch.full((b,), 1, dtype=torch.int32)
                    q = torch.zeros(b, s, h, d, dtype=qdtype)
                    fake.calls.clear()
                    t_paged._launch(q, pages, pages, table, fills,
                                    scales.get("k_scales"),
                                    scales.get("v_scales"))
                    call = fake.calls[0]
                    assert call[3] == t_paged.VARIANTS[plan.variant]
                    assert call[1:3] == (plan.rows, plan.blocks)
                    assert call[4:] == (plan.splits, plan.pages_per_split)
                    assert call[3] != decode or s <= 8
    # the serving decode shape: 8 slots x 12 heads, 16 pages a slot
    plan = t_paged.paged_plan(8, 1, 12, 12, 64, 64, 16, torch.bfloat16,
                              torch.bfloat16)
    assert plan.variant == "decode" and plan.rows == 1
    assert 8 * 12 * plan.splits >= 2 * 132


# -- weight quantization ------------------------------------------------------


def test_quantize_tree_matches_jax():
    from pyspark_tf_gke_tpu.ops.quant import quantize_tree as jax_qtree

    rng = np.random.default_rng(3)
    tree = {"wte": {"embedding": rng.standard_normal((97, 64))},
            "lm_head": {"kernel": rng.standard_normal((64, 97)),
                        "bias": rng.standard_normal(97)}}
    tree = {m: {k: v.astype(np.float32) for k, v in d.items()}
            for m, d in tree.items()}
    jq = jax_qtree(tree)
    flat = {f"{m}/{k}": _t(v) for m, d in tree.items() for k, v in d.items()}
    tq = quantize_tree(flat)
    for path in ("wte/embedding", "lm_head/kernel"):
        m, k = path.split("/")
        np.testing.assert_array_equal(tq[path].q.numpy(),
                                      np.asarray(jq[m][k].q))
        np.testing.assert_array_equal(tq[path].scale.numpy(),
                                      np.asarray(jq[m][k].scale))
    assert tq["wte/embedding"].scale.shape == (97, 1)   # per row
    assert tq["lm_head/kernel"].scale.shape == (97,)    # per column
    assert isinstance(tq["lm_head/bias"], torch.Tensor)  # 1-D stays dense


def test_flash_tma_layouts():
    """The bf16 flash forward reads q/k/v by TMA: contiguous [B, S, H, D]
    and the q/k/v views of a fused [B, S, 3, H, D] projection qualify
    (any S, ragged ones too); a head_dim that is not contiguous, a base
    off 16 bytes or a stride that is not a multiple of 8 elements does
    not; the stride of a size-1 dimension is never followed."""
    for s in (77, 200, 512):
        assert t_flash.tma_compatible(torch.zeros(2, s, 12, 64))
        for t in torch.zeros(2, s, 3, 12, 64).unbind(2):
            assert t_flash.tma_compatible(t)
    base = torch.zeros(2, 5, 2, 72)
    assert not t_flash.tma_compatible(base[..., 1:65])  # base off 16 bytes
    assert not t_flash.tma_compatible(torch.zeros(2, 5, 2, 68)[..., :64])
    assert not t_flash.tma_compatible(torch.zeros(2, 5, 2, 64, 2)[..., 0])
    one = torch.zeros(1, 7, 1, 67)[..., :64]  # B = H = 1: only S strides
    assert not t_flash.tma_compatible(one)
    assert t_flash.tma_compatible(torch.zeros(1, 1, 1, 64))
