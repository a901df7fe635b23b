"""The (x, y) laser-spot regressor (counterpart of
``pyspark_tf_gke_tpu/models/cnn.py``), the reference's flagship image
model: five blocks of a 5x5 SAME conv (8 -> 16 -> 32 -> 64 -> 64
channels, with bias), PReLU and a 2x2 stride-2 VALID max pool (none
after the fifth), then the B1 head (``flat=True``: Flatten ->
Dense(2048)) or the A1 head (global mean -> Dense(128)), relu, and
Dense(``num_outputs``) cast to f32.

The layout is the JAX one: NHWC activations, HWIO conv kernels (run by
``F.conv2d`` on channels-last views, ``models/resnet.py::conv_nhwc``; the
JAX package runs these convs, the pools and the Dense layers in XLA,
outside any Pallas kernel), B1's Flatten in (H, W, C) order so that
``Dense_0/kernel [20480, 2048]`` lines up, and per-element PReLU alphas
``[H, W, C]`` (Keras' default; ``prelu_shared_axes=(1, 2)`` gives one a
channel). Flax infers the alpha shapes and the flatten width on first
call; here they follow from ``image_size``. B1 at 256x320 has
43,368,850 parameters (convs 170,384, alphas 1,249,280, dense
41,949,186). The parameters are f32 master weights cast to the compute
dtype at each use (``dtype=None`` is f32); ``jnp.mean``'s f32 sum of a
bf16 map is kept. The initial parameters are the JAX model's at the
same ``seed`` (``utils/seeding.jax_init_params``: Keras' glorot-uniform
kernels replayed bit for bit in numpy, biases and alphas zero);
``load_params`` takes the JAX tree.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pyspark_tf_gke_tpu_torch.models.layers import (Dense, build_device,
                                                    flatten_flax,
                                                    load_flax_params)
from pyspark_tf_gke_tpu_torch.models.resnet import conv_nhwc
from pyspark_tf_gke_tpu_torch.utils.seeding import (DEFAULT_SEED,
                                                    jax_init_params)


class PReLU(nn.Module):
    """``max(x, 0) + alpha * min(x, 0)`` with a learned f32 alpha over a
    feature map of ``shape`` ``(H, W, C)``, cast to x's dtype.
    ``shared_axes`` counts from the batch axis as in flax: ``(1, 2)``
    shares H and W (one alpha a channel)."""

    def __init__(self, shape: Sequence[int],
                 shared_axes: Optional[Sequence[int]] = None):
        super().__init__()
        shape = list(shape)
        for ax in shared_axes or ():
            shape[ax - 1] = 1
        self.alpha = nn.Parameter(torch.zeros(shape, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return (torch.maximum(x, zero)
                + self.alpha.to(x.dtype) * torch.minimum(x, zero))


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME", dtype=dtype)``:
    ``kernel [k, k, cin, features]`` (HWIO) and ``bias [features]``."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(
            kernel_size, kernel_size, cin, features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x.to(self.dtype), self.kernel.to(self.dtype))
        return y + self.bias.to(self.dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (2, 2), strides=(2, 2))`` on NHWC: VALID, odd
    sizes floored."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class CNNRegressor(nn.Module):
    def __init__(self, num_outputs: int = 2, flat: bool = False,
                 features: Sequence[int] = (8, 16, 32, 64, 64),
                 dtype: Optional[torch.dtype] = None,
                 prelu_shared_axes: Optional[Sequence[int]] = None,
                 image_size: Tuple[int, int] = (256, 320),
                 device: Union[str, torch.device] = "cuda",
                 seed: int = DEFAULT_SEED):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.flat = flat
        self.num_blocks = len(features)
        h, w = image_size
        cin = 3
        target = build_device(device)
        with torch.device(target):
            for i, feat in enumerate(features):
                self.add_module(f"Conv_{i}", Conv(cin, feat, 5, self.dtype))
                self.add_module(f"PReLU_{i}",
                                PReLU((h, w, feat), prelu_shared_axes))
                if i < self.num_blocks - 1:
                    h, w = h // 2, w // 2
                cin = feat
            width = h * w * cin if flat else cin
            self.Dense_0 = Dense(width, 2048 if flat else 128, self.dtype,
                                 torch.float32)
            self.Dense_1 = Dense(self.Dense_0.kernel.shape[1], num_outputs,
                                 self.dtype, torch.float32)
        if target.type != "meta":
            load_flax_params(self, jax_init_params(self, seed))

    def load_params(self, params: Mapping) -> "CNNRegressor":
        """Copy the JAX model's ``params`` tree (host arrays) in."""
        load_flax_params(self, flatten_flax(params))
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, H, W, 3]`` -> ``[B, num_outputs]`` f32."""
        x = x.to(self.dtype)
        for i in range(self.num_blocks):
            x = getattr(self, f"PReLU_{i}")(getattr(self, f"Conv_{i}")(x))
            if i < self.num_blocks - 1:
                x = max_pool_2x2(x)
        if self.flat:
            x = x.reshape(x.shape[0], -1)  # (H, W, C) order
        else:
            x = x.float().mean(dim=(1, 2)).to(self.dtype)
        x = torch.relu(self.Dense_0(x))
        return self.Dense_1(x).float()
