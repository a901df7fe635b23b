"""The KMeans workload's knobs and constants (the port's copy of
``pyspark_tf_gke_tpu/etl/knobs.py``): the reference Spark job's weighting
and KMeans constants, with the same environment parsing and clamps, so
the native chain and the JAX package's can never drift on them."""

from __future__ import annotations

import os
from typing import List, Sequence

# The reference's KMeans constants (k_means.py:83).
KMEANS_SEED = 1
KMEANS_MAX_ITER = 1000
DEFAULT_K = 25
DEFAULT_MEASURE_WEIGHT = 5

NUMERIC_COLS = ("value", "lower_ci", "upper_ci")


def measure_weight() -> int:
    """``MEASURE_NAME_WEIGHT`` (default 5, clamped >= 1): how many times
    the one-hot block repeats in the feature vector — repeating a block
    m times scales its squared-distance contribution by m."""
    try:
        repeats = int(os.environ.get(
            "MEASURE_NAME_WEIGHT", str(DEFAULT_MEASURE_WEIGHT)))
    except ValueError:
        repeats = DEFAULT_MEASURE_WEIGHT
    return max(1, repeats)


def kmeans_k() -> int:
    """``KMEANS_K`` (default 25, clamped >= 2)."""
    try:
        k = int(os.environ.get("KMEANS_K", str(DEFAULT_K)))
    except ValueError:
        k = DEFAULT_K
    return max(2, k)


def assemble_feature_cols(repeats: int,
                          numeric_cols: Sequence[str] = NUMERIC_COLS,
                          onehot_col: str = "measure_name_vec") -> List[str]:
    """The VectorAssembler input order: [one-hot x repeats, numerics]."""
    return [onehot_col] * max(1, repeats) + list(numeric_cols)
