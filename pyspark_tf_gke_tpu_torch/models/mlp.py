"""MLP classifier (counterpart of ``pyspark_tf_gke_tpu/models/mlp.py``),
the reference's CSV classifier: Dense 16 -> 32 -> 64 -> ``num_classes``
with relu, logits cast to f32 (softmax lives in the loss).

Flax infers the input width on first call; here it is ``input_dim``.
The parameters keep flax's paths (``Dense_0/kernel [in, out]``,
``Dense_0/bias``) as f32 master weights cast to the compute dtype at
each use (``dtype=None`` is f32), initialised as the JAX model's
``init(jax.random.key(seed), x)`` initialises it: Keras' glorot-uniform
kernels and zero biases, replayed bit for bit in numpy
(``utils/seeding.jax_init_params``). ``load_params`` takes the JAX
model's ``params`` tree.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch
from torch import nn

from pyspark_tf_gke_tpu_torch.models.layers import (Dense, build_device,
                                                    flatten_flax,
                                                    load_flax_params)
from pyspark_tf_gke_tpu_torch.utils.seeding import (DEFAULT_SEED,
                                                    jax_init_params)


class MLPClassifier(nn.Module):
    def __init__(self, num_classes: int, input_dim: int,
                 hidden: Sequence[int] = (16, 32, 64),
                 dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda",
                 seed: int = DEFAULT_SEED):
        super().__init__()
        self.dtype = dtype or torch.float32
        widths = (input_dim, *hidden, num_classes)
        self.num_layers = len(widths) - 1
        target = build_device(device)
        with torch.device(target):
            for i in range(self.num_layers):
                self.add_module(f"Dense_{i}", Dense(
                    widths[i], widths[i + 1], self.dtype, torch.float32))
        if target.type != "meta":
            load_flax_params(self, jax_init_params(self, seed))

    def load_params(self, params: Mapping) -> "MLPClassifier":
        """Copy the JAX model's ``params`` tree (host arrays) in."""
        load_flax_params(self, flatten_flax(params))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_layers - 1}")(x).float()
