"""PyTorch port, training kernels on the CPU: the backwards of flash
attention (K2dq/K2dkv) and LayerNorm (K3b) through their
``autograd.Function``s and plain versions, held against ``jax.grad`` of
the JAX package's kernels run as its own tests run them (Pallas
``interpret=True``, small blocks), on the same numpy inputs; ``gradcheck``
in f64; paged attention refuses a gradient.

Tolerances: f32 gradients within 5e-5 absolute (+1e-4 relative) — both
sides compute in f32 and differ by summation order over at most 32 keys
or rows of O(1) values. bf16 flash backward (the same bf16 q, k, v, out,
dO and lse into the JAX package's ``_flash_bwd_bh`` and the port): dv
bit-identical, dq and dk bit-identical but for elements within one bf16
step of the JAX value or 2e-6 absolute (see that test). bf16 LayerNorm:
dx within one bf16 rounding of the JAX value (rtol 8e-3 plus 1e-2 of the
largest |dx|; both round the same f32 closed form once), dscale/dbias
(f32 sums of bf16 inputs) within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.ops.pallas.flash_attention import (
    NEG_INF as JAX_NEG_INF, _flash_bwd_bh as jax_flash_bwd_bh,
    flash_attention as jax_flash)
from pyspark_tf_gke_tpu.ops.pallas.layernorm import (
    fused_layernorm as jax_layernorm)
from pyspark_tf_gke_tpu_torch.ops import flash_attention as t_flash
from pyspark_tf_gke_tpu_torch.ops import layernorm as t_ln
from pyspark_tf_gke_tpu_torch.ops import paged_attention as t_paged

torch.set_num_threads(1)

GRAD_ATOL = 5e-5
GRAD_RTOL = 1e-4


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


# -- K2dq / K2dkv ---------------------------------------------------------------


def _flash_case(case, rng, d=8):
    b, s, h = 2, 32, 2
    q, k, v, w = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    kv_mask = segs = None
    if case in ("segments", "all"):
        segs = np.repeat(np.arange(4), 8)[None].repeat(b, 0).astype(np.int32)
        segs[1] = np.repeat(np.arange(2), 16)
    if case == "all":
        kv_mask = rng.random((b, s)) > 0.25
        kv_mask[:, 8] = False  # row 8's only visible key is padding: empty
        kv_mask[1] = False     # batch row 1: no key at all
    return q, k, v, w, kv_mask, segs


def _with_widths(cases, base, widths=(16, 80, 128)):
    """``(case, d)`` parameters: each case at the ``base`` width under its
    own id, then at each of ``widths`` as ``case-dD``."""
    return ([pytest.param(c, base, id=c) for c in cases]
            + [pytest.param(c, d, id=f"{c}-d{d}") for d in widths
               for c in cases])


@pytest.mark.parametrize("case,d",
                         _with_widths(["causal", "segments", "all"], 8))
def test_flash_backward_matches_jax_grad(case, d):
    rng = np.random.default_rng(20)
    q, k, v, w, kv_mask, segs = _flash_case(case, rng, d)

    def jax_loss(q, k, v):
        out = jax_flash(q, k, v,
                        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
                        causal=True,
                        segment_ids=None if segs is None else jnp.asarray(segs),
                        block_q=8, block_k=8, interpret=True)
        return jnp.sum(out * w)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (_t(a, True) for a in (q, k, v))
    tmask = None if kv_mask is None else _t(kv_mask)
    tsegs = None if segs is None else _t(segs)
    out = t_flash.flash_attention(tq, tk, tv, kv_mask=tmask, causal=True,
                                  segment_ids=tsegs)
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)

    # the plain backward on its own, from the forward's residuals
    with torch.no_grad():
        o, lse = t_flash.flash_attention_fwd(_t(q), _t(k), _t(v), tmask,
                                             True, tsegs)
        delta = (_t(w) * o).sum(-1).transpose(1, 2)
        grads = t_flash.flash_attention_bwd_plain(
            _t(q), _t(k), _t(v), _t(w), lse, delta, tmask, True, tsegs)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if case == "all":
        assert torch.all(tq.grad[1] == 0) and torch.all(tk.grad[1] == 0)
        assert torch.all(tq.grad[0, 8] == 0)  # the empty row


def test_flash_gradcheck_f64():
    rng = np.random.default_rng(21)
    q, k, v = (_t(rng.standard_normal((2, 6, 2, 4)), True) for _ in range(3))
    segs = _t(np.asarray([[0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 2, 2]], np.int32))
    kv_mask = _t(np.asarray([[1, 1, 0, 1, 1, 1], [1, 1, 1, 1, 1, 1]], bool))
    fn = lambda q, k, v: t_flash.flash_attention(  # noqa: E731
        q, k, v, kv_mask=kv_mask, causal=True, segment_ids=segs)
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.mark.parametrize("case,d",
                         _with_widths(["causal", "segments", "masked",
                                       "masked_s77"], 64))
def test_flash_backward_bf16_rounds_where_jax_rounds(case, d):
    """The bf16 backward rounds P to bf16 before dV and dS before dK and
    dQ, as the TPU kernels do. The same bf16 q, k, v, dO and the port
    forward's out and lse go through the JAX package's ``_flash_bwd_bh``
    (Pallas ``interpret=True``, blocks of 16) and the port's autograd
    Function and plain version. Before the repair (P and dS in f32) ~40%
    of the elements differed, by up to 0.031. Now dv is bit-identical.
    dq and dk are bit-identical but for a few elements: dP and delta =
    rowsum(dO * O) are f32 sums taken in another order by XLA and by
    torch, so where dP - delta is a rounding residual (a query row that
    sees one key, whose dS is then ~1e-7 instead of 0) a bf16 dS can land
    one rounding apart, and an f32 sum over keys or queries taken in
    another order than the JAX kernel's blocks of 16 can round to the
    neighbouring bf16 value. Such an element is within one bf16 step
    (2**-7 relative) of the JAX value or within 2e-6 absolute, and at
    most 1/32 of the elements differ at all. ``masked_s77``: the masked
    case at a ragged S = 77 (JAX blocks of 11), the edge that bf16 K2dq's
    128-row and K2dkv's 128-key CTAs meet on the card. At head width 64
    (the cases above) and at 16, 80 and 128, whose kernels round at the
    same points; at those three dv is held within one bf16 step and the
    1/32 count is of the elements more than 2e-6 apart (see below)."""
    case, _, ragged = case.partition("_")
    b, s, h = 2, (77 if ragged else 64), 2
    block = 11 if ragged else 16
    rng = np.random.default_rng(30)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v, do = (bf16((b, s, h, d)) for _ in range(4))
    kv_mask = segs = None
    if case in ("segments", "masked"):
        segs = torch.from_numpy((np.arange(s) // 16).astype(
            np.int32))[None].repeat(b, 1)
    if case == "masked":
        kv_mask = torch.from_numpy(rng.random((b, s)) > 0.25)
        kv_mask[:, 16] = False  # row 16 sees only key 16: an empty row
        kv_mask[1] = False      # batch row 1: no key at all
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = t_flash.flash_attention(tq, tk, tv, kv_mask=kv_mask, causal=True,
                                  segment_ids=segs)
    out.backward(do)
    with torch.no_grad():
        out, lse = t_flash.flash_attention_fwd(q, k, v, kv_mask, True, segs)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        plain = t_flash.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                  kv_mask, True, segs)

    def to_bh(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16).transpose(
            0, 2, 1, 3).reshape(b * h, s, d)

    bias = jnp.zeros((b, s), jnp.float32) if kv_mask is None else jnp.where(
        jnp.asarray(kv_mask.numpy()), 0.0, JAX_NEG_INF).astype(jnp.float32)
    bias = jnp.repeat(bias, h, axis=0)[:, None, :]
    jsegs = None if segs is None else jnp.repeat(
        jnp.asarray(segs.numpy()), h, axis=0)[:, None, :]
    ref = jax_flash_bwd_bh(to_bh(q), to_bh(k), to_bh(v), bias,
                           jnp.asarray(lse.numpy()).reshape(b * h, 1, s),
                           to_bh(out), to_bh(do), jsegs, causal=True,
                           block_q=block, block_k=block, interpret=True)
    for name, got_fn, got_plain, want in zip(
            ("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), plain, ref):
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).reshape(
            b, h, s, d).transpose(1, 2)
        for how, got in (("autograd", got_fn), ("plain", got_plain)):
            assert got.dtype == torch.bfloat16
            got = got.float()
            off = got != want
            if name == "dv" and d == 64:
                assert not off.any(), f"{case} {how} dv"
            near = (got - want).abs() <= torch.maximum(
                want.abs() * 2.0 ** -7, torch.full_like(want, 2e-6))
            assert bool(near.all()), (case, how, name,
                                      float((got - want).abs().max()))
            # at the other widths, a query row that sees one key differs
            # in all D of its dq elements (each by < 2e-6, as above), and
            # an f32 score summed over more terms can round P to the
            # neighbouring bf16 value: there the count is of the elements
            # beyond that 2e-6 floor
            counted = off if d == 64 else (got - want).abs() > 2e-6
            assert int(counted.sum()) <= want.numel() // 32, (case, how,
                                                              name)


def _cu_constant(text: str, name: str) -> int:
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


DKV_BLOCK_K, DKV_BLOCK_Q = 128, 64  # bf16 K2dkv's keys a CTA, queries a tile


def _dkv_launch_order(b: int, s: int, h: int, causal: bool):
    """``[(batch, head, first key, query tiles)]`` of bf16 K2dkv's CTAs
    in launch order (grid x = B*H fastest, y = key blocks): a causal
    block walks the query tiles from its first key on."""
    tiles = -(-s // DKV_BLOCK_Q)
    return [(bh // h, bh % h, kb * DKV_BLOCK_K,
             tiles - (kb * DKV_BLOCK_K // DKV_BLOCK_Q if causal else 0))
            for kb in range(-(-s // DKV_BLOCK_K)) for bh in range(b * h)]


def test_dkv_grid_follows_the_kernel_and_fills_the_h100():
    """bf16 K2dkv (csrc/flash_attention_bwd.cu wg::): CTAs of 128 keys
    walking 64-row query tiles, the grid (B*H, key blocks) with the key
    block the slow axis, so that causal CTAs launch longest first; at
    the LM training shape (B=16 S=512 H=12) its 768 CTAs are more than
    five waves of an H100's 132 SMs and the whole first wave sees every
    query tile. Ragged S: the last block is partial."""
    from pathlib import Path

    src = (Path(t_flash.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    wg = src[src.index("namespace wg {"):]
    assert _cu_constant(wg, "kBK") == DKV_BLOCK_K
    assert _cu_constant(wg, "kBQ") == DKV_BLOCK_Q
    assert "const dim3 grid(B * H, (S + kBK - 1) / kBK);" in wg
    assert "const int k0 = blockIdx.y * kBK;" in wg
    assert "const int qt0 = causal ? k0 / kBQ : 0;" in wg

    order = _dkv_launch_order(16, 512, 12, causal=True)
    assert len(order) == 768 >= 132
    tiles = [o[3] for o in order]
    assert tiles == sorted(tiles, reverse=True)
    assert all(o[2] == 0 and o[3] == 8 for o in order[:132])
    assert {o[:3] for o in order} == {(b, h, k0) for b in range(16)
                                      for h in range(12)
                                      for k0 in (0, 128, 256, 384)}
    assert all(o[3] == 8 for o in _dkv_launch_order(16, 512, 12,
                                                    causal=False))
    ragged = _dkv_launch_order(3, 200, 12, causal=True)
    assert len(ragged) == 36 * 2 and ragged[-1][2:] == (128, 4 - 2)


DQ_BLOCK_Q, DQ_BLOCK_K = 128, 64  # bf16 K2dq's rows a CTA, keys a tile


def _dq_launch_order(b: int, s: int, h: int, causal: bool):
    """``[(batch, head, first row, key tiles)]`` of bf16 K2dq's CTAs in
    launch order (grid x = B*H fastest, y = query blocks taken from the
    last down): a causal CTA walks the key tiles up to its last row."""
    blocks = -(-s // DQ_BLOCK_Q)
    order = []
    for y in range(blocks):
        q0 = (blocks - 1 - y) * DQ_BLOCK_Q
        last = min(q0 + DQ_BLOCK_Q, s) - 1
        tiles = (last if causal else s - 1) // DQ_BLOCK_K + 1
        order += [(bh // h, bh % h, q0, tiles) for bh in range(b * h)]
    return order


def test_dq_grid_follows_the_kernel_and_fills_the_h100():
    """bf16 K2dq (csrc/flash_attention_bwd.cu wgdq::): CTAs of 128 query
    rows walking 64-key tiles, the grid (B*H, query blocks) with the
    query block the slow axis taken from the last block down, so that
    causal CTAs launch longest first; at the LM training shape (B=16
    S=512 H=12) its 768 CTAs are more than five waves of an H100's 132
    SMs and the whole first wave walks every key tile. Ragged S: the
    last block is partial and walks the tiles up to S."""
    from pathlib import Path

    src = (Path(t_flash.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    wg = src[src.index("namespace wgdq {"):]
    assert _cu_constant(wg, "kBQ") == DQ_BLOCK_Q
    assert _cu_constant(wg, "kBK") == DQ_BLOCK_K
    assert "const dim3 grid(B * H, (S + kBQ - 1) / kBQ);" in wg
    assert "const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;" in wg
    assert "const int ntiles = (causal ? q_last : S - 1) / kBK + 1;" in wg

    order = _dq_launch_order(16, 512, 12, causal=True)
    assert len(order) == 768 > 5 * 132
    tiles = [o[3] for o in order]
    assert tiles == sorted(tiles, reverse=True)
    assert all(o[2] == 384 and o[3] == 8 for o in order[:132])
    assert {o[:3] for o in order} == {(b, h, q0) for b in range(16)
                                      for h in range(12)
                                      for q0 in (0, 128, 256, 384)}
    assert all(o[3] == 8 for o in _dq_launch_order(16, 512, 12,
                                                   causal=False))
    ragged = _dq_launch_order(3, 200, 12, causal=True)
    assert len(ragged) == 36 * 2
    assert ragged[0][2:] == (128, 4) and ragged[-1][2:] == (0, 2)


@pytest.mark.parametrize("kernel", ["flash_attention_dq",
                                    "flash_attention_dkv"],
                         ids=["dq", "dkv"])
def test_dkv_wrapper_copies_an_unaddressable_dout_and_refuses_q(
        kernel, monkeypatch):
    """bf16 K2dkv and K2dq read q, k, v and dout by TMA. An expanded or
    strided cotangent, as autograd may hand over, is copied into a
    layout TMA can address (the kernel gets the copy's strides); an
    addressable one is passed as it is; a q, k or v that TMA cannot
    address raises, as the forward does. (The kernel library is replaced
    by a recorder: no card here.)"""
    calls = []

    class FakeLibrary:
        def port_flash_attention_dq(self, *args):
            calls.append(args)
            return 0

        port_flash_attention_dkv = port_flash_attention_dq

    monkeypatch.setattr(t_flash.kernels, "require_cuda",
                        lambda kernel, *ts: ts[0].device)
    monkeypatch.setattr(t_flash.kernels, "library", FakeLibrary)
    monkeypatch.setattr(t_flash.kernels, "launch_args", lambda dev: (0, 0))
    b, s, h, d = 2, 8, 3, 64
    q, k, v = (torch.zeros(b, s, h, d, dtype=torch.bfloat16)
               for _ in range(3))
    lse, delta = (torch.zeros(b, h, s) for _ in range(2))
    wrapper = getattr(t_flash, kernel)
    # q, k, v, dout strides (batch, seq, head) follow the leading
    # pointers and sizes: 13 for K2dq (one output), 14 for K2dkv (two)
    at = 22 if kernel == "flash_attention_dq" else 23
    expanded = torch.ones(b, 1, h, d, dtype=torch.bfloat16).expand(b, s, h, d)
    sliced = torch.ones(b, s, h, d + 4, dtype=torch.bfloat16)[..., :d]
    assert not t_flash.tma_compatible(expanded)
    assert not t_flash.tma_compatible(sliced)
    for dout in (expanded, sliced):
        got = t_flash.tma_dout(dout)
        assert got is not dout and t_flash.tma_compatible(got)
        assert torch.equal(got, dout)
        calls.clear()
        wrapper(dout, q, k, v, lse, delta, causal=True)
        # the kernel got a contiguous dout
        assert calls[0][at:at + 3] == (s * h * d, h * d, d)
    ok = torch.ones(b, s, h, d, dtype=torch.bfloat16)
    assert t_flash.tma_dout(ok) is ok
    bad_q = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16)[..., :d]
    with pytest.raises(ValueError, match="TMA"):
        wrapper(ok, bad_q, k, v, lse, delta)
    with pytest.raises(ValueError, match="TMA"):
        wrapper(ok, q, k, bad_q, lse, delta)
    # f32 runs the CUDA-core kernel, which takes any head_dim-contiguous
    # strides: no copy, no refusal
    calls.clear()
    q32 = q.float()
    sliced32 = torch.ones(b, s, h, d + 4)[..., :d]
    wrapper(sliced32, q32, q32, q32, lse, delta)
    assert calls[0][at:at + 3] == (s * h * (d + 4), h * (d + 4), d + 4)


# -- K3b ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("d", [64, 1280, 4096])
def test_layernorm_backward_matches_jax_grad(residual, dtype, d):
    """Widths: 64, GPT-2 large's 1280 and 4096 (K3b's wide variant on the
    card)."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 8, d)).astype(np.float32) * 2 + 0.5
    r = rng.standard_normal((4, 8, d)).astype(np.float32)
    w = rng.standard_normal((4, 8, d)).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def jax_loss(x, r, scale, bias):
        y = jax_layernorm(x, scale, bias, eps=1e-5, interpret=True,
                          residual=r if residual else None)
        return jnp.sum(y.astype(jnp.float32) * w)

    jx, jr = jnp.asarray(x, jdt), jnp.asarray(r, jdt)
    ref = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        jx, jr, jnp.asarray(scale), jnp.asarray(bias))

    tdt = getattr(torch, dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_()
    tr = _t(np.asarray(jr.astype(jnp.float32))).to(tdt).requires_grad_()
    ts, tb = _t(scale, True), _t(bias, True)
    y = t_ln.fused_layernorm(tx, ts, tb, eps=1e-5,
                             residual=tr if residual else None)
    assert y.dtype == tdt
    (y.float() * _t(w)).sum().backward()
    want = {"x": ref[0], "scale": ref[2], "bias": ref[3]}
    got = {"x": tx.grad, "scale": ts.grad, "bias": tb.grad}
    if residual:
        want["r"], got["r"] = ref[1], tr.grad
    else:
        assert tr.grad is None
    for name in want:
        g = got[name].float().numpy()
        ref_np = np.asarray(want[name].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g, ref_np, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)
        elif name in ("x", "r"):
            np.testing.assert_allclose(
                g, ref_np, rtol=8e-3, atol=1e-2 * np.abs(ref_np).max(),
                err_msg=name)
        else:
            np.testing.assert_allclose(g, ref_np, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref_np).max(),
                                       err_msg=name)


@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_gradcheck_f64(residual):
    rng = np.random.default_rng(23)
    x = _t(rng.standard_normal((3, 8)) * 2, True)
    r = _t(rng.standard_normal((3, 8)), True)
    scale = _t(rng.standard_normal(8), True)
    bias = _t(rng.standard_normal(8), True)
    if residual:
        fn = lambda x, r, s, b: t_ln.fused_layernorm(  # noqa: E731
            x, s, b, eps=1e-5, residual=r)
        assert torch.autograd.gradcheck(fn, (x, r, scale, bias))
    else:
        fn = lambda x, s, b: t_ln.fused_layernorm(  # noqa: E731
            x, s, b, eps=1e-5)
        assert torch.autograd.gradcheck(fn, (x, scale, bias))


def test_layernorm_bwd_plain_is_the_wrappers_cpu_path():
    rng = np.random.default_rng(24)
    x, g = (_t(rng.standard_normal((5, 16)).astype(np.float32))
            for _ in range(2))
    scale = _t(rng.standard_normal(16).astype(np.float32))
    for a, b in zip(t_ln.layernorm_bwd(g, x, scale, 1e-5),
                    t_ln.layernorm_bwd_plain(g, x, scale, 1e-5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [1280, 4096])
def test_layernorm_wrappers_hand_wide_rows_to_the_kernels(d, monkeypatch):
    """``layernorm_fwd`` and ``layernorm_bwd`` hand rows of GPT-2
    large's 1280 and of 4096 to the kernels with ``ln_plan``'s launch
    shape (before the width repair both raised ValueError for D >
    1024), and K3b's partial-sum rows follow the plan: one a CTA, a CTA
    holding ``bwd_threads / bwd_row_threads`` rows at a time. Meta
    tensors stand in for CUDA ones and a recorder for the kernel
    library: no card here."""
    calls = {}

    class FakeLibrary:
        def port_layernorm(self, *args):
            calls["fwd"] = args
            return 0

        def port_layernorm_bwd(self, *args):
            calls["bwd"] = args
            return 0

    monkeypatch.setattr(t_ln.kernels, "require_cuda",
                        lambda kernel, *ts: ts[0].device)
    monkeypatch.setattr(t_ln.kernels, "library", FakeLibrary)
    monkeypatch.setattr(t_ln.kernels, "launch_args", lambda dev: (0, 0))
    x, r, g = (torch.zeros(3, 5, d, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    scale, bias = (torch.zeros(d, device="meta") for _ in range(2))
    plan = t_ln.ln_plan(d, torch.bfloat16)
    assert plan.vec == 8 and plan.row_threads > 32
    y = t_ln.layernorm_fwd(x, scale, bias, 1e-5, residual=r)
    assert y.shape == x.shape
    # x, r, scale, bias, y, rows, d, eps, vec, per, row_threads, threads
    args = calls["fwd"]
    assert args[5:7] == (15, d) and args[8:12] == tuple(plan[:4])
    dx, dscale, dbias = t_ln.layernorm_bwd(g, x, scale, 1e-5, residual=r)
    assert dx.shape == x.shape and dscale.shape == dbias.shape == (d,)
    # x, r, g, scale, dx, parts, parts, dscale, dbias, rows, d, nparts,
    # vec, per, row_threads, threads
    args = calls["bwd"]
    assert args[9:12] == (15, d, -(-15 // plan.bwd_rows_a_part))
    assert args[12:16] == tuple(plan[4:])
    assert plan.bwd_vec == 8 and plan.bwd_threads == 256


# -- K1 has no backward ---------------------------------------------------------


def test_paged_attention_refuses_a_gradient():
    kp = torch.randn(4, 4, 2, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    fills = torch.ones(1, dtype=torch.int32)
    q = torch.randn(1, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        t_paged.paged_attention(q, kp, kp, table, fills)
    with pytest.raises(RuntimeError, match="no backward"):
        t_paged.paged_attention_chunk(q[:, None], kp, kp.requires_grad_(),
                                      table, fills)
    with torch.no_grad():
        out = t_paged.paged_attention(q, kp, kp, table, fills)
    assert out.shape == (1, 2, 8) and not out.requires_grad
