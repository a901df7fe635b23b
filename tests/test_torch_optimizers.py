"""PyTorch port, ``--optimizer lamb`` and ``adafactor`` against optax
0.2.6, the JAX package's factory (``train/harness.py:25-106``).

Five updates of a flax-shaped tree — a 160x130 matrix (factored by
adafactor), a 3-D leaf whose two largest dims are >= 128 (factored over
them), a sub-128 matrix and a 3-D leaf that are not factored, and
vectors (never decayed) — from the same numpy gradients, through
``make_optimizer`` in both packages: with and without weight decay
(mask ``ndim >= 2``), global-norm clipping and ``warmup_cosine``. A
zero leaf checks LAMB's trust ratio of 1. Tolerance: 1e-6 relative to
each element and to the largest value of its leaf (an element near 0
takes the rounding of ``p - lr * u`` at the leaf's scale), in f32 — the
same f32 formulas, whose means and norms sum in another order on each
side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pyspark_tf_gke_tpu.train.harness import make_optimizer as jax_optimizer
from pyspark_tf_gke_tpu_torch.train.harness import (_factored_dims,
                                                    make_optimizer)

torch.set_num_threads(1)

RTOL = 1e-6
SHAPES = {"dense/kernel": (160, 130), "dense/bias": (130,),
          "attn/kernel": (3, 128, 140), "small/kernel": (40, 24),
          "small3/kernel": (2, 40, 200), "ln/scale": (24,),
          "zero/kernel": (16, 8)}


def _tree(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _params(rng):
    return {k: (np.zeros(s, np.float32) if k.startswith("zero") else
                rng.normal(0, 0.5, s).astype(np.float32))
            for k, s in SHAPES.items()}


CASES = {
    "lamb": dict(optimizer="lamb"),
    "lamb_wd_clip_cosine": dict(optimizer="lamb", weight_decay=0.01,
                                grad_clip_norm=0.5,
                                schedule="warmup_cosine", warmup_steps=2,
                                total_steps=8),
    "adafactor": dict(optimizer="adafactor"),
    "adafactor_wd_clip_cosine": dict(optimizer="adafactor",
                                     weight_decay=0.01, grad_clip_norm=0.5,
                                     schedule="warmup_cosine",
                                     warmup_steps=2, total_steps=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(7)
    params = _params(rng)
    grads = [{k: (rng.normal(0, 1, s) * (3.0 if i == 2 else 1.0)).astype(
        np.float32) for k, s in SHAPES.items()} for i in range(5)]
    for g in grads:  # a leaf with no gradient: its updates stay 0
        g["ln/scale"][:] = 0.0

    jtx = jax_optimizer(1e-2, **kw)
    jparams = jax.tree.map(jnp.asarray, _tree(params))
    jstate = jtx.init(jparams)
    tx = make_optimizer(1e-2, **kw)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, _tree(g)),
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tx.update({k: torch.tensor(v) for k, v in g.items()}, tstate,
                  tparams)
    want = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    assert tstate["count"] == 5
    for k, v in tparams.items():
        np.testing.assert_allclose(
            v.numpy(), want[k], rtol=RTOL,
            atol=RTOL * float(np.abs(want[k]).max()), err_msg=f"{case}: {k}")
        if k.startswith("zero") and "lamb" in case and "wd" not in case:
            # zero params: trust ratio 1, the leaf moves by adam's update
            assert np.abs(v.numpy()).max() > 0


def test_adafactor_factors_the_two_largest_dims():
    # optax's own choice, including ties and sub-128 leaves
    from optax._src.factorized import _factored_dims as optax_dims

    for shape in [(160, 130), (3, 128, 140), (40, 24), (128, 128), (256,),
                  (2, 40, 200), (130, 7, 129)]:
        assert _factored_dims(shape) == optax_dims(shape, True, 128), shape
    tx = make_optimizer(1e-2, optimizer="adafactor")
    state = tx.init({k: torch.zeros(s) for k, s in SHAPES.items()})
    assert set(state["v_row"]) == {"dense/kernel", "attn/kernel"}
    assert tuple(state["v_row"]["attn/kernel"].shape) == (3, 128)
    assert tuple(state["v_col"]["attn/kernel"].shape) == (3, 140)
    assert "small/kernel" in state["v"] and "ln/scale" in state["v"]


def test_weight_decay_check_takes_every_decaying_optimizer():
    for name in ("adamw", "lamb", "adafactor"):
        make_optimizer(1e-3, optimizer=name, weight_decay=0.1)
    with pytest.raises(ValueError, match="adamw, lamb or adafactor"):
        make_optimizer(1e-3, optimizer="adam", weight_decay=0.1)
