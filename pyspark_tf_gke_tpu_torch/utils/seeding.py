"""Deterministic seeding (the port's copy of
``pyspark_tf_gke_tpu/utils/seeding.py``).

The numpy half: the default seed 1337 and the numpy generator the data
pipeline shuffles and masks with.

The JAX-key half: the JAX package's reference-parity models start from
``model.init(jax.random.key(seed), x)``, flax's Keras glorot-uniform
kernels drawn from Threefry-2x32 keys. :func:`jax_init_params` computes
the same parameters bit for bit in numpy (no JAX), so the port's MLP and
CNN start where the JAX CLI starts for the same ``--seed``:

* ``_threefry2x32``: JAX's Threefry-2x32 hash, 20 rounds;
* ``_flax_key``: the key flax hands a parameter, ``fold_in`` of the
  first 4 bytes of the SHA-1 of the module path and the scope's counter;
* ``_glorot_uniform``: ``uniform``'s bits (partitionable Threefry over
  each element's index) as floats in [-1, 1), times the Glorot bound.
"""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

DEFAULT_SEED = 1337


def np_rng(seed: int = DEFAULT_SEED) -> np.random.Generator:
    """The numpy generator used for deterministic shuffles and splits."""
    return np.random.default_rng(seed)


def _threefry2x32(k1, k2, x0, x1):
    """JAX's Threefry-2x32 (20 rounds) over uint32 numpy arrays."""
    x0, x1 = x0.astype(np.uint32), x1.astype(np.uint32)
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
                x0 += x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _flax_key(seed: int, *suffix) -> Tuple[int, int]:
    """The key flax's ``make_rng('params')`` hands a parameter of the
    module at ``suffix`` (its path, then the scope's counter) under
    ``jax.random.key(seed)``: ``fold_in`` of the first 4 bytes of the
    suffix's SHA-1."""
    m = hashlib.sha1()
    for x in suffix:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    data = int.from_bytes(m.digest()[:4], "big")
    o1, o2 = _threefry2x32(seed >> 32, seed & 0xFFFFFFFF,
                           np.zeros(1, np.uint32),
                           np.array([data], np.uint32))
    return int(o1[0]), int(o2[0])


def _glorot_uniform(key: Tuple[int, int], shape: Sequence[int],
                    chunk: int = 1 << 20) -> np.ndarray:
    """``nn.initializers.glorot_uniform()(key, shape)`` (f32) in numpy:
    the partitionable Threefry bits of each element's index, 23 of them
    as a float in [1, 2), mapped to [-1, 1) and scaled by ``sqrt(3 *
    2 / (fan_in + fan_out))``."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)

    def fill(lo: int) -> None:
        idx = np.arange(lo, min(n, lo + chunk), dtype=np.uint32)
        o1, o2 = _threefry2x32(key[0], key[1], np.zeros_like(idx), idx)
        f = (((o1 ^ o2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
            np.float32) - np.float32(1.0)
        out[lo:lo + len(idx)] = np.maximum(np.float32(-1.0),
                                           f * np.float32(2.0)
                                           + np.float32(-1.0))

    # numpy's ufuncs release the GIL: the chunks run in parallel
    with ThreadPoolExecutor(max_workers=8) as ex:
        for done in [ex.submit(fill, lo) for lo in range(0, n, chunk)]:
            done.result()
    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = receptive * shape[-2], receptive * shape[-1]
    scale = np.float32(np.sqrt(np.float32(3.0 / ((fan_in + fan_out) / 2.0))))
    return (out * scale).reshape(shape)


def jax_init_params(model: torch.nn.Module,
                    seed: int = DEFAULT_SEED) -> Dict[str, torch.Tensor]:
    """The initial parameters ``model.init(jax.random.key(seed), x)``
    gives the JAX twin of a reference-parity model (``MLPClassifier``,
    ``CNNRegressor``: Keras glorot-uniform kernels, every bias and PReLU
    alpha zero), recomputed in numpy, as ``{flax path: f32 tensor}``.
    A kernel is the first parameter its module makes (counter 1)."""
    out = {}
    for name, p in model.named_parameters():
        *module, leaf = name.split(".")
        shape = tuple(p.shape)
        arr = (_glorot_uniform(_flax_key(seed, *module, 1), shape)
               if leaf == "kernel" else np.zeros(shape, np.float32))
        out["/".join((*module, leaf))] = torch.from_numpy(arr)
    return out
