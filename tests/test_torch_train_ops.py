"""PyTorch port, training kernels on the CPU: the backwards of flash
attention (K2dq/K2dkv) and LayerNorm (K3b) through their
``autograd.Function``s and plain versions, held against ``jax.grad`` of
the JAX package's kernels run as its own tests run them (Pallas
``interpret=True``, small blocks), on the same numpy inputs; ``gradcheck``
in f64; paged attention refuses a gradient.

Tolerances: f32 gradients within 5e-5 absolute (+1e-4 relative) — both
sides compute in f32 and differ by summation order over at most 32 keys
or rows of O(1) values. bf16 LayerNorm: dx within one bf16 rounding of
the JAX value (rtol 8e-3 plus 1e-2 of the largest |dx|; both round the
same f32 closed form once), dscale/dbias (f32 sums of bf16 inputs)
within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.ops.pallas.flash_attention import (
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


def _flash_case(case, rng):
    b, s, h, d = 2, 32, 2, 8
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


@pytest.mark.parametrize("case", ["causal", "segments", "all"])
def test_flash_backward_matches_jax_grad(case):
    rng = np.random.default_rng(20)
    q, k, v, w, kv_mask, segs = _flash_case(case, rng)

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


# -- K3b ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_backward_matches_jax_grad(residual, dtype):
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32) * 2 + 0.5
    r = rng.standard_normal((4, 8, 64)).astype(np.float32)
    w = rng.standard_normal((4, 8, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
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
