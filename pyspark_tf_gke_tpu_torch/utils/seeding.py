"""Deterministic seeding (the port's copy of the numpy half of
``pyspark_tf_gke_tpu/utils/seeding.py``): the default seed 1337 and the
numpy generator the data pipeline shuffles and masks with. The JAX
PRNG-key helpers have no counterpart: the port draws its random numbers
from numpy generators and ``torch.Generator``s."""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 1337


def np_rng(seed: int = DEFAULT_SEED) -> np.random.Generator:
    """The numpy generator used for deterministic shuffles and splits."""
    return np.random.default_rng(seed)
