"""PyTorch port, the ResNet training slices on the CPU against the JAX
package: the fused 1x1-conv op (K4f forward, K4dx and K4dw backward,
through the plain versions the wrappers take for CPU tensors) against
the JAX ``norm_relu_matmul`` (its Pallas kernels in interpret mode, as
``tests/test_fused_resnet.py`` runs them); a small ResNet in every
variant (``fused``, ``fused3``, ``bn``, ``bn_f32``, ``gn``, ``none``,
``nf``, and the s2d stem under ``bn`` and ``nf``) against the JAX model
with the same weights (train-mode logits, every running statistic,
every gradient, eval-mode logits); 3 Adam steps of the port's
``Trainer`` against the JAX ``Trainer`` (``fused``, ``fused3``, and the
statistics-free ``nf``); and a checkpoint round trip of the batch
statistics. The K5 op itself is held against JAX in
``tests/test_torch_fused_conv3.py``.

The weights are made with numpy and handed to both models, so no JAX
init runs for the model tests. ``norm3_scale`` (``nf``: ``skip_gain``)
is zero at init, which makes every residual-branch gradient exactly
zero (only the shortcut, projections, stem, head and norm3 carry
gradient); the gradient cases set it non-zero (numpy-seeded) as well as
leaving it at zero. ``gn`` needs channels in groups of 32, so it runs
at ``num_filters=32``.

Tolerances, f32 throughout unless stated (both sides compute the same
f32 products and sums in another order):
* op: outputs and gradients within 1e-5 relative (of the largest
  element of the reference) — a few f32 roundings of sums over <= 37
  terms; bf16: 1 bf16 rounding (8e-3 relative) of y, dx and dw, and
  2e-3 relative for the f32 statistics and d a, d b (sums of values
  that may sit one bf16 rounding apart);
* model: logits 1e-4, running statistics 1e-5, gradients 2e-3
  relative to each tensor's largest element (through BatchNorm's
  1/std, up to four blocks deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.models import resnet as jresnet
from pyspark_tf_gke_tpu.ops.pallas import fused_matmul as jfm
from pyspark_tf_gke_tpu.train import trainer as jtrainer
from pyspark_tf_gke_tpu_torch.models import resnet as tresnet
from pyspark_tf_gke_tpu_torch.ops import fused_matmul as tfm
from pyspark_tf_gke_tpu_torch.train import trainer as ttrainer
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
IMAGE = (2, 32, 32, 3)
# the model tests' cases: ResNet keyword arguments beside SMALL's. SMALL
# has one stride-1 block (K5 under fused3) and one stride-2 block
CASES = {
    "fused": dict(norm_variant="fused"),
    "fused3": dict(norm_variant="fused3"),
    "bn": dict(norm_variant="bn"),
    "bn_f32": dict(norm_variant="bn_f32"),
    "gn": dict(norm_variant="gn", num_filters=32),
    "none": dict(norm_variant="none"),
    "nf": dict(norm_variant="nf"),
    "bn_s2d": dict(norm_variant="bn", s2d_stem=True),
    "nf_s2d": dict(norm_variant="nf", s2d_stem=True),
}
# the weights' numpy seed per case (default 45). At seed 45 one
# pre-relu BatchNorm output of bn_s2d's second block lies 5.8e-7 from 0,
# within the two frameworks' f32 rounding of each other, so its relu
# mask can flip and move every gradient upstream of it by ~10%: a kink
# of relu, not a fault of either side
SEEDS = {"bn_s2d": 46}


def _close(got, want, rel, what=""):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


# -- the op -------------------------------------------------------------------


def _op_inputs(m, k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=k).astype(np.float32)
    b = rng.normal(size=k).astype(np.float32) * 0.5
    cy = rng.normal(size=(m, n)).astype(np.float32)
    cs = rng.normal(size=n).astype(np.float32)
    css = rng.normal(size=n).astype(np.float32) * 0.1
    return x, w, a, b, cy, cs, css


def _jax_op(x, w, a, b, cy, cs, css, transform, relu, want_stats, dtype):
    """JAX outputs and gradients of ``sum(y*cy) + sum(s*cs) +
    sum(ss*css)`` (the stats terms only with ``want_stats``)."""

    def f(x, w, a, b):
        out = jfm.norm_relu_matmul(
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
    out = tfm.norm_relu_matmul(tx, tw, ta if transform else None,
                               tb if transform else None, relu=relu,
                               want_stats=want_stats)
    if want_stats:
        y, s, ss = out
        loss = ((y * torch.tensor(cy)).sum() + (s * torch.tensor(cs)).sum()
                + (ss * torch.tensor(css)).sum())
        outs = out
    else:
        loss = (out * torch.tensor(cy)).sum()
        outs = (out,)
    wrt = (tx, tw, ta, tb) if transform else (tx, tw)
    grads = torch.autograd.grad(loss, wrt)
    return ([o.detach().float().numpy() for o in outs],
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("mode", ["none", "affine", "relu"])
def test_norm_relu_matmul_matches_jax_f32(mode, want_stats):
    inputs = _op_inputs(37, 13, 11, seed=40)
    kw = dict(transform=mode != "none", relu=mode == "relu",
              want_stats=want_stats)
    jouts, jgrads = _jax_op(*inputs, dtype=jnp.float32, **kw)
    touts, tgrads = _port_op(*inputs, dtype=torch.float32, **kw)
    for name, got, want in zip(("y", "sum", "sumsq"), touts, jouts):
        _close(got, want, 1e-5, name)
    for name, got, want in zip(("dx", "dw", "da", "db"), tgrads, jgrads):
        _close(got, want, 1e-5, name)


def test_norm_relu_matmul_matches_jax_bf16():
    inputs = _op_inputs(45, 19, 23, seed=41)
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
    """The hand-written backward (K4dx + K4dw through their plain
    versions on the CPU) equals autograd through K4f's plain forward,
    and ``norm_relu_matmul_plain`` (the plain versions on any device)
    equals the wrapper on the CPU bit for bit."""
    x, w, a, b, cy, cs, css = (torch.tensor(t) for t in _op_inputs(
        29, 17, 9, seed=42))

    def autograd_plain(x, w, a, b, relu, want_stats):
        y, stats = tfm._fwd_plain(x, w, a, b, relu, want_stats)
        return y, stats[0], stats[1]

    res = []
    for fn in (tfm.norm_relu_matmul, tfm.norm_relu_matmul_plain,
               autograd_plain):
        p = [t.clone().requires_grad_() for t in (x, w, a, b)]
        y, s, ss = (fn(*p, True, True) if fn is autograd_plain
                    else fn(*p, relu=True, want_stats=True))
        loss = (y * cy).sum() + (s * cs).sum() + (ss * css).sum()
        res.append((y, s, ss) + torch.autograd.grad(loss, p))
    for got, same, want in zip(*res):
        assert torch.equal(got, same)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="together"):
        tfm.norm_relu_matmul(x, w, a, None)


def test_k4_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: a
    meta tensor (no card needed) is refused, as are a dtype mismatch and
    a missing half of the transform."""
    x = torch.empty(5, 3, device="meta")
    w = torch.empty(3, 4, device="meta")
    a = torch.empty(3, device="meta")
    dy = torch.empty(5, 4, device="meta")
    for call in (lambda: tfm.norm_relu_matmul_fwd(x, w, a, a, True, True),
                 lambda: tfm.norm_relu_matmul_dx(dy, w, x, a, a, True),
                 lambda: tfm.norm_relu_matmul_dw(x, dy, None, None, False)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="together"):
        tfm.norm_relu_matmul_fwd(x, w, a, None, True, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tresnet.ResNet(**SMALL, norm_variant="fused", device="cuda")


def test_dw_splits_cover_m_in_block_k_steps():
    for m, k, n in ((200704, 64, 256), (3136, 2048, 512), (37, 13, 11),
                    (12544, 1024, 256), (1, 1, 1)):
        splits, chunk = tfm.dw_splits(m, k, n)
        assert chunk % tfm.BLOCK_K == 0 and chunk > 0
        assert (splits - 1) * chunk < m <= splits * chunk
    assert tfm.dw_splits(200704, 64, 256)[0] > 100  # 4 tiles: split M


# ResNet-50's 36 fused 1x1 convs at batch 64: the 15 distinct (M, K, N)
# of its 16 shapes (two differ only in the transform)
RESNET50_K4_SHAPES = (
    (200704, 64, 64), (200704, 64, 256), (200704, 256, 64),
    (200704, 256, 128), (50176, 128, 512), (50176, 256, 512),
    (50176, 512, 128), (50176, 512, 256), (12544, 256, 1024),
    (12544, 512, 1024), (12544, 1024, 256), (12544, 1024, 512),
    (3136, 512, 2048), (3136, 1024, 2048), (3136, 2048, 512))


@pytest.mark.parametrize("m,k,n", RESNET50_K4_SHAPES + ((1000, 72, 40),))
def test_bf16_dw_plan_covers_m_in_whole_steps(m, k, n):
    """bf16 K4dw's plan: the rows in whole 64-row steps, every split
    non-empty and at least one step, a CTA tile of 64 or 128 a side —
    64 where K (N) is at most 64, so no half of a tile is empty at stage
    1 — and a grid the kernel can launch; f32 keeps ``dw_splits``."""
    tk, tn, splits, chunk = tfm.dw_plan(m, k, n, torch.bfloat16)
    assert chunk % tfm.DW_STEP == 0 and chunk >= tfm.DW_STEP
    assert (splits - 1) * chunk < m <= splits * chunk
    assert tk == (64 if k <= 64 else 128) and tn == (64 if n <= 64 else 128)
    tiles = -(-k // tk) * -(-n // tn)
    assert tiles * splits <= 2 ** 31 - 1
    if m >= tfm.DW_MIN_STEPS * tfm.DW_STEP:
        assert chunk >= tfm.DW_MIN_STEPS * tfm.DW_STEP
    assert tfm.dw_plan(m, k, n, torch.float32) == (
        tfm.BLOCK_M, tfm.BLOCK_N) + tfm.dw_splits(m, k, n)


class _RecordingK4dwLibrary:
    """Stands in for the built kernel library: records the arguments of
    ``port_k4_dw`` and refuses what it refuses for bf16 (a CTA tile
    other than 1 or 2 warpgroup tiles a side)."""

    def __init__(self):
        self.calls = []

    def port_k4_dw(self, *args):
        m, kdim, n, transform, splits, chunk, tk, tn = args[6:14]
        self.calls.append((m, kdim, n, splits, chunk, tk, tn))
        return 0 if tk in (1, 2) and tn in (1, 2) else 1


@pytest.mark.parametrize("m,k,n", RESNET50_K4_SHAPES[::4] + ((1000, 72, 40),))
def test_bf16_k4dw_launches_at_the_plan_tile(m, k, n, monkeypatch):
    """The K4dw wrapper hands ``dw_plan``'s tile and split to the kernel,
    which dispatches on them: the tile rule lives in the plan alone.
    Shape-only tensors stand in for the card's, and the launch is
    recorded instead of run."""
    from pyspark_tf_gke_tpu_torch.ops import kernels

    lib = _RecordingK4dwLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(kernels, "launch_args", lambda device: (0, None))
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    dy = torch.empty(m, n, dtype=torch.bfloat16, device="meta")
    a = torch.empty(k, dtype=torch.float32, device="meta")
    dw = tfm.norm_relu_matmul_dw(x, dy, a, a, True)
    assert tuple(dw.shape) == (k, n) and dw.dtype == torch.bfloat16
    tk, tn, splits, chunk = tfm.dw_plan(m, k, n, torch.bfloat16)
    assert lib.calls == [(m, k, n, splits, chunk, tk // tfm.DW_WG_TILE,
                          tn // tfm.DW_WG_TILE)]


@pytest.mark.parametrize("m,k,n", RESNET50_K4_SHAPES + ((1000, 72, 40),))
def test_k4_plan_tiles_cover_the_output(m, k, n):
    """K4f's and K4dx's plan: bf16 tiles of 128 rows (the tensor-core
    kernel's ``wg::kBM``) by 64 columns where the output is at most 64
    wide (no half-empty tile at stage 1) and 128 beyond; f32 keeps the
    CUDA-core kernel's ``BLOCK_M`` x ``BLOCK_N``. The tiles cover the
    output, K4f's [M, N] and K4dx's [M, K] alike."""
    from pathlib import Path

    csrc = Path(tfm.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "fused_matmul.cu").read_text()
    wg = text[text.index("namespace wg {"):]
    assert int(wg.split("constexpr int kBM = ")[1].split(";")[0]) == (
        tfm.K4_BLOCK_M)
    for rows, red, cols in ((m, k, n), (m, n, k)):  # K4f, K4dx
        for dtype in (torch.bfloat16, torch.float32):
            bm, bn, tiles_m, tiles_n = tfm.k4_plan(rows, red, cols, dtype)
            if dtype == torch.bfloat16:
                assert (bm, bn) == (tfm.K4_BLOCK_M, 64 if cols <= 64 else 128)
            else:
                assert (bm, bn) == (tfm.BLOCK_M, tfm.BLOCK_N)
            assert (tiles_m - 1) * bm < rows <= tiles_m * bm
            assert (tiles_n - 1) * bn < cols <= tiles_n * bn


class _RecordingK4Library:
    """Stands in for the built kernel library: records the arguments of
    ``port_k4_fwd`` and ``port_k4_dx`` after the dtype-independent ones
    (M, K, N, the transform, K4f's want_stats and the tile width),
    checks the count against ``kernels.SIGNATURES``, and refuses what
    the C entry points refuse (bf16: a tile other than 64 or 128 wide;
    f32: other than 64)."""

    def __init__(self):
        self.calls = []

    def _record(self, name, args, first):
        from pyspark_tf_gke_tpu_torch.ops import kernels

        assert len(args) == len(kernels.SIGNATURES[name])
        fields = args[first:-3]
        self.calls.append((name,) + tuple(fields))
        block_n, dtype = args[-4], args[-3]
        ok = block_n in (64, 128) if dtype == 1 else block_n == 64
        return 0 if ok else 1

    def port_k4_fwd(self, *args):
        return self._record("port_k4_fwd", args, 7)

    def port_k4_dx(self, *args):
        return self._record("port_k4_dx", args, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", RESNET50_K4_SHAPES[::4] + ((1000, 72, 40),))
def test_k4_fwd_and_dx_launch_at_the_plan_tile(m, k, n, dtype, monkeypatch):
    """The K4f and K4dx wrappers size the statistics partials ``[tiles_m,
    2, C]`` from ``k4_plan`` and hand its tile width to the kernel,
    which dispatches on it. Shape-only tensors stand in for the card's,
    and the launches are recorded instead of run."""
    from pyspark_tf_gke_tpu_torch.ops import kernels

    lib = _RecordingK4Library()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require_cuda", lambda name, *t: t[0].device)
    monkeypatch.setattr(kernels, "launch_args", lambda device: (0, None))
    partials = []
    empty = torch.empty

    def recording_empty(*shape, **kwargs):
        dims = tuple(shape[0]) if isinstance(shape[0], tuple) else shape
        if kwargs.get("dtype") == torch.float32 and len(dims) == 3:
            partials.append(dims)
        return empty(*shape, **kwargs)

    monkeypatch.setattr(torch, "empty", recording_empty)
    x = torch.empty(m, k, dtype=dtype, device="meta")
    w = torch.empty(k, n, dtype=dtype, device="meta")
    dy = torch.empty(m, n, dtype=dtype, device="meta")
    a = torch.empty(k, dtype=torch.float32, device="meta")
    y, stats = tfm.norm_relu_matmul_fwd(x, w, a, a, True, True)
    assert tuple(y.shape) == (m, n) and tuple(stats.shape) == (2, n)
    dx, dstats = tfm.norm_relu_matmul_dx(dy, w, x, a, a, True)
    assert tuple(dx.shape) == (m, k) and tuple(dstats.shape) == (2, k)
    _, bn_f, tiles_f, _ = tfm.k4_plan(m, k, n, dtype)
    _, bn_d, tiles_d, _ = tfm.k4_plan(m, n, k, dtype)
    assert partials == [(tiles_f, 2, n), (tiles_d, 2, k)]
    assert lib.calls == [("port_k4_fwd", m, k, n, 2, 1, bn_f),
                         ("port_k4_dx", m, k, n, 2, bn_d)]


def test_bn_helpers_match_jax():
    rng = np.random.default_rng(43)
    s, ss = rng.normal(size=7), rng.uniform(0, 3, size=7)
    s[0], ss[0] = 10.0, 1.0  # a negative variance, clamped at 0
    mean, var, scale, bias = (rng.normal(size=7).astype(np.float32)
                              for _ in range(4))
    var = np.abs(var)
    for got, want in zip(
            tfm.stats_to_moments(torch.tensor(s, dtype=torch.float32),
                                 torch.tensor(ss, dtype=torch.float32), 10),
            jfm.stats_to_moments(jnp.asarray(s, jnp.float32),
                                 jnp.asarray(ss, jnp.float32), 10)):
        _close(got.numpy(), want, 1e-6)
    for got, want in zip(
            tfm.bn_fold(*(torch.tensor(t) for t in (mean, var, scale, bias)),
                        1e-5),
            jfm.bn_fold(*(jnp.asarray(t) for t in (mean, var, scale, bias)),
                        1e-5)):
        _close(got.numpy(), want, 1e-6)


# -- the model ----------------------------------------------------------------


def _numpy_variables(case, seed, norm3):
    """flax variables of the small ResNet of ``case`` (a :data:`CASES`
    key), made with numpy from the model's own shapes (``eval_shape``: no
    JAX init runs). ``norm3``: "zero" keeps norm3's scale (``nf``:
    ``skip_gain``) at its init, "random" sets it non-zero."""
    jmodel = jresnet.ResNet(**{**SMALL, **CASES[case]}, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.zeros(IMAGE),
                                                  train=False),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = leaf.shape
        if name.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape).astype(np.float32) / np.sqrt(fan_in)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        is_norm3 = any(n in name for n in ("norm3_scale", "BatchNorm_2/scale",
                                           "GroupNorm_2/scale", "skip_gain"))
        if is_norm3 and norm3 == "zero":
            return np.zeros(shape, np.float32)
        if name.endswith(("scale", "gain")):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.1).astype(np.float32)

    return jmodel, jax.tree_util.tree_map_with_path(fill, shapes)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _batch(seed=44):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, size=IMAGE).astype(np.float32),
            "label": rng.integers(0, 10, size=IMAGE[0]).astype(np.int32)}


def _jax_reference(case):
    """Per norm3 case: train-mode logits, loss, the new batch stats, the
    gradients, and eval-mode logits from the updated running stats (one
    compiled step for both cases). Statistics-free variants have an empty
    ``batch_stats``."""
    batch = _batch()
    task = jtrainer.resnet_task()
    jmodel = jresnet.ResNet(**{**SMALL, **CASES[case]}, dtype=jnp.float32)

    def loss_fn(params, stats):
        variables = {"params": params, **({"batch_stats": stats} if stats
                                          else {})}
        preds, new_stats = task.forward(jmodel, variables, batch, True, True)
        loss, _ = task.loss_and_metrics(preds, batch)
        return loss, (preds, new_stats or {})

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    evaluate = jax.jit(lambda v: jmodel.apply(v, batch["image"], train=False))
    out = {}
    for norm3 in ("zero", "random"):
        _, variables = _numpy_variables(case, SEEDS.get(case, 45), norm3)
        (loss, (logits, new_stats)), grads = step(
            variables["params"], variables.get("batch_stats", {}))
        evals = evaluate({"params": variables["params"],
                          **({"batch_stats": new_stats} if new_stats
                             else {})})
        out[norm3] = dict(variables=jax.device_get(variables),
                          loss=float(loss), logits=np.asarray(logits),
                          stats=_flat(jax.device_get(new_stats)),
                          grads=_flat(jax.device_get(grads)),
                          eval_logits=np.asarray(evals))
    return out


_REFERENCES = {}


def _reference(case):
    """:func:`_jax_reference` of ``case``, computed once per process."""
    if case not in _REFERENCES:
        _REFERENCES[case] = _jax_reference(case)
    return _REFERENCES[case]


@pytest.fixture(scope="module")
def jax_fused():
    return _reference("fused")


@pytest.fixture(scope="module")
def jax_fused3():
    return _reference("fused3")


def _port_model(case, variables, **kw):
    model = tresnet.ResNet(**{**SMALL, **CASES[case]}, dtype=torch.float32,
                           device="cpu", **kw)
    model.load_state_dict(tresnet.params_from_flax(variables))
    return model


@pytest.mark.parametrize("norm3", ["zero", "random"])
@pytest.mark.parametrize("variant", list(CASES))
def test_small_resnet_matches_jax(variant, norm3):
    ref = _reference(variant)[norm3]
    model = _port_model(variant, ref["variables"])
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    task = ttrainer.resnet_task()
    logits = task.forward(model, batch, train=True)
    loss, _ = task.loss_and_metrics(logits, batch)
    loss.backward()
    _close(logits.detach().numpy(), ref["logits"], 1e-4, "train logits")
    assert float(loss.detach()) == pytest.approx(ref["loss"], abs=1e-5)
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(ref["stats"])
    for name, want in ref["stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    params = dict(model.named_parameters())
    assert set(params) == set(ref["grads"])
    for name, want in ref["grads"].items():
        if norm3 == "zero" and not np.any(want):
            # the residual branch behind a zero norm3 scale: exactly zero
            assert not params[name].grad.any(), name
            continue
        _close(params[name].grad.numpy(), want, 2e-3, name)
    branch = {"fused": "FusedBottleneckBlock_0.conv1_kernel",
              "fused3": "FusedBottleneckBlock_0.conv2_kernel",
              "nf": "NFBottleneckBlock_0.conv2.kernel"}.get(variant)
    if branch is not None:  # the residual branch's gradient: zero or not
        assert np.any(ref["grads"][branch]) == (norm3 == "random")
    with torch.no_grad():
        evals = task.forward(model, batch, train=False)
    _close(evals.numpy(), ref["eval_logits"], 1e-4, "eval logits")
    # eval reads the running statistics and leaves them as they were
    for name, want in ref["stats"].items():
        np.testing.assert_allclose(buffers[name].numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant", ["fused", "fused3"])
def test_fused_use_kernels_false_matches_the_default_on_cpu(
        variant, jax_fused, jax_fused3):
    """``use_kernels=False`` (the plain versions on any device) and the
    default (the K4 and K5 wrappers, which take the plain versions for
    CPU tensors) give the same logits and gradients on the CPU."""
    ref = jax_fused if variant == "fused" else jax_fused3
    variables = ref["random"]["variables"]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    task = ttrainer.resnet_task()
    grads = []
    for use_kernels in (True, False):
        model = _port_model(variant, variables, use_kernels=use_kernels)
        loss, _ = task.loss_and_metrics(task.forward(model, batch), batch)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_unported_variants_raise():
    """Every variant of the JAX module is ported: an unknown one raises
    ``ValueError``, as in JAX, and so does GroupNorm-32 on channels that
    do not split into 32 groups (flax raises there too)."""
    with pytest.raises(ValueError, match="norm_variant"):
        tresnet.ResNet50(norm_variant="layer", device="cpu")
    with pytest.raises(ValueError, match="GroupNorm"):
        tresnet.ResNet(**SMALL, norm_variant="gn", device="cpu")


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(50).normal(size=(2, 6, 4, 3)).astype(
        np.float32)
    got = tresnet.space_to_depth(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jresnet.space_to_depth(x, 2)))
    with pytest.raises(ValueError, match="divisible"):
        tresnet.space_to_depth(torch.zeros(1, 5, 4, 3), 2)


def test_resnet50_shapes_and_names_match_flax():
    jmodel = jresnet.ResNet50(num_classes=1000, dtype=jnp.bfloat16,
                              norm_variant="fused")
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 224, 224, 3)), train=False), jax.random.key(0))
    want = {k: tuple(v.shape) for k, v in _flat(shapes["params"]).items()}
    want.update({k: tuple(v.shape)
                 for k, v in _flat(shapes["batch_stats"]).items()})
    model = tresnet.ResNet50(norm_variant="fused", device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)),
    (7, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (16, 3, 2, (0, 1))])
def test_same_pads_are_xla_same(size, kernel, stride, pads):
    import jax.lax as lax

    assert tresnet.same_pads(size, kernel, stride) == pads
    assert tuple(lax.padtype_to_pads((size,), (kernel,), (stride,),
                                     "SAME")[0]) == pads


# -- training -----------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fused", "fused3", "nf"])
def test_three_adam_steps_match_jax_trainer(devices, variant):
    """The port's ``Trainer`` and ``resnet_task`` against the JAX ones,
    unchanged for the K5 path (``fused3``) and for a variant without
    statistics (``nf``: JAX keeps ``batch_stats=None``, the port an empty
    dict)."""
    from pyspark_tf_gke_tpu.data.pipeline import put_global_batch
    from pyspark_tf_gke_tpu.parallel.mesh import batch_sharding, make_mesh
    from pyspark_tf_gke_tpu.utils.seeding import make_rng

    mesh = make_mesh({"dp": 1}, devices[:1])
    jmodel = jresnet.ResNet(**SMALL, dtype=jnp.float32, norm_variant=variant)
    batch = _batch(46)
    jt = jtrainer.Trainer(jmodel, jtrainer.TASKS["resnet"](), mesh,
                          learning_rate=1e-3)
    state = jt.init_state(make_rng(0), batch)
    jstats = state.batch_stats or {}
    model = _port_model(variant, jax.device_get(
        {"params": state.params, "batch_stats": jstats}))
    tt = ttrainer.Trainer(model, ttrainer.TASKS["resnet"](),
                          learning_rate=1e-3)
    tstate = tt.init_state()
    assert set(tstate.batch_stats) == set(_flat(jax.device_get(jstats)))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlosses, tlosses = [], []
    for _ in range(3):
        state, m = jt.step(state, put_global_batch(batch,
                                                   batch_sharding(mesh)))
        jlosses.append(float(jax.device_get(m["loss"])))
        tstate, tm = tt.step(tstate, tbatch)
        tlosses.append(float(tm["loss"]))
    assert tstate.step == 3
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5)
    # bn_init.bias has a gradient that is zero up to rounding: every
    # consumer of the pooled (all-positive) stem output is a 1x1 conv
    # followed by a BatchNorm, which removes a per-channel shift. Adam
    # turns that rounding noise into steps of ~lr in either framework,
    # so the bias drifts apart by up to 3 lr, and the running means
    # downstream of it (a shifted input, normalised away before the
    # loss) by up to ~3e-4 after 3 steps: allow 1e-3 there, and hold
    # every other parameter to 1e-5 and the stem's own statistics
    # (upstream of the bias) to 1e-5.
    jparams = _flat(jax.device_get(state.params))
    for name, p in tstate.params.items():
        if name != "bn_init.bias":
            np.testing.assert_allclose(p.detach().numpy(), jparams[name],
                                       atol=1e-5, err_msg=name)
    for name, want in _flat(jax.device_get(state.batch_stats or {})).items():
        atol = 1e-5 if name.startswith("bn_init") else 1e-3
        np.testing.assert_allclose(tstate.batch_stats[name].numpy(), want,
                                   rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", ["fused", "fused3"])
def test_checkpoint_round_trips_batch_stats(tmp_path, variant):
    batch = {k: torch.from_numpy(v) for k, v in _batch(47).items()}

    def trainer(seed):
        model = tresnet.ResNet(**SMALL, dtype=torch.float32,
                               norm_variant=variant, device="cpu", seed=seed)
        return ttrainer.Trainer(model, ttrainer.TASKS["resnet"](),
                                learning_rate=1e-3)

    tt = trainer(0)
    state = tt.init_state()
    assert state.batch_stats is not None and all(
        "norm" in k or "bn_init" in k for k in state.batch_stats)
    init = {k: v.clone() for k, v in state.batch_stats.items()}
    for _ in range(2):
        tt.step(state, batch)
    assert any(not torch.equal(init[k], v)
               for k, v in state.batch_stats.items())
    before = tt.evaluate(state, [batch])
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(state)
    other = trainer(5)
    restored = ckpt.restore(other.init_state())
    assert restored.step == 2
    for name, v in state.batch_stats.items():
        assert torch.equal(restored.batch_stats[name], v)
        assert torch.equal(dict(other.model.named_buffers())[name], v)
    assert other.evaluate(restored, [batch]) == before
    # a state without batch statistics does not take them silently
    no_stats = trainer(6)
    bare = no_stats.init_state()
    bare.batch_stats = None
    with pytest.raises(ValueError, match="batch_stats"):
        ckpt.restore(bare)


def test_checkpoint_round_trips_a_model_without_statistics(tmp_path):
    """``nf`` has no BatchNorm statistics: its training state carries an
    empty ``batch_stats``, which saves and restores with the rest."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(47).items()}

    def trainer(seed):
        model = tresnet.ResNet(**SMALL, dtype=torch.float32,
                               norm_variant="nf", device="cpu", seed=seed)
        return ttrainer.Trainer(model, ttrainer.TASKS["resnet"](),
                                learning_rate=1e-3)

    tt = trainer(0)
    state = tt.init_state()
    assert state.batch_stats == {}
    for _ in range(2):
        tt.step(state, batch)
    before = tt.evaluate(state, [batch])
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    ckpt.save(state)
    other = trainer(5)
    restored = ckpt.restore(other.init_state())
    assert restored.step == 2 and restored.batch_stats == {}
    for name, p in state.params.items():
        assert torch.equal(restored.params[name], p), name
    assert other.evaluate(restored, [batch]) == before


def test_grad_accum_averages_batch_stats_as_jax_does():
    """Two microbatches from the same running statistics: the new
    statistics are the mean of the two single-batch updates."""
    b1 = {k: torch.from_numpy(v) for k, v in _batch(48).items()}
    b2 = {k: torch.from_numpy(v) for k, v in _batch(49).items()}
    model = tresnet.ResNet(**SMALL, dtype=torch.float32, norm_variant="fused",
                           device="cpu")
    tt = ttrainer.Trainer(model, ttrainer.TASKS["resnet"](),
                          learning_rate=1e-3)
    state = tt.init_state()
    start = {k: v.clone() for k, v in state.batch_stats.items()}
    single = []
    for b in (b1, b2):
        for k, v in start.items():
            state.batch_stats[k].copy_(v)
        with torch.no_grad():
            model(b["image"], train=True)
        single.append({k: v.clone() for k, v in state.batch_stats.items()})
    for k, v in start.items():
        state.batch_stats[k].copy_(v)
    tt.accum_step(state, iter([b1, b2]), 2)
    for k, v in state.batch_stats.items():
        torch.testing.assert_close(v, (single[0][k] + single[1][k]) / 2)
