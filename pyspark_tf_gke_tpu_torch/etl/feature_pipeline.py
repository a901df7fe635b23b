"""The KMeans feature pipeline with Spark MLlib's semantics, on the host
(the port's copy of ``pyspark_tf_gke_tpu/etl/feature_pipeline.py``;
numpy only, and its matrix is the JAX module's bit for bit):

1. drop rows with a null clustering target (``measure_name``);
2. StringIndexer: category -> index by descending frequency, ties
   alphabetical (``frequencyDesc``);
3. OneHotEncoder with ``dropLast=True`` (the last category is all
   zeros; an unseen category too, ``handleInvalid="keep"``);
4. mean imputation of null/NaN numerics (f64 ``nanmean`` over the kept
   rows, stored f32);
5. the one-hot block repeated ``MEASURE_NAME_WEIGHT`` times;
6. ``[one-hot x repeats, numerics...]`` as one dense f32 matrix.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence

import numpy as np

from pyspark_tf_gke_tpu_torch.etl.knobs import NUMERIC_COLS, measure_weight


def string_index(values: Sequence[str]) -> Dict[str, int]:
    """Spark StringIndexer ``frequencyDesc``: most frequent -> 0; ties
    alphabetical."""
    counts = Counter(values)
    ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return {cat: i for i, (cat, _) in enumerate(ordered)}


def _non_null(cats: np.ndarray) -> np.ndarray:
    return np.array([c is not None and c == c for c in cats])


class FeaturePipeline:
    def __init__(self, category_col: str = "measure_name",
                 numeric_cols: Sequence[str] = NUMERIC_COLS,
                 repeats: Optional[int] = None, drop_last: bool = True):
        if repeats is None:
            repeats = measure_weight()
        self.repeats = max(1, int(repeats))
        self.category_col = category_col
        self.numeric_cols = list(numeric_cols)
        self.drop_last = drop_last
        self.index_map: Optional[Dict[str, int]] = None
        self.means: Optional[np.ndarray] = None

    def fit(self, rows: Dict[str, np.ndarray]) -> "FeaturePipeline":
        """``rows``: column name -> array (categories as an object array,
        numerics as float arrays that may hold NaN)."""
        keep = _non_null(rows[self.category_col])
        self.index_map = string_index(list(rows[self.category_col][keep]))
        self.means = np.array(
            [np.nanmean(np.asarray(rows[c], dtype=np.float64)[keep])
             for c in self.numeric_cols], dtype=np.float32)
        return self

    @property
    def onehot_width(self) -> int:
        n = len(self.index_map)
        return n - 1 if self.drop_last else n

    def transform(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        if self.index_map is None:
            raise RuntimeError("fit() first")
        cats = rows[self.category_col]
        keep = _non_null(cats)
        cats = cats[keep]
        width = self.onehot_width
        onehot = np.zeros((len(cats), width), dtype=np.float32)
        for i, c in enumerate(cats):
            idx = self.index_map.get(c)
            if idx is not None and idx < width:
                onehot[i, idx] = 1.0
        numerics = []
        for j, col in enumerate(self.numeric_cols):
            v = np.asarray(rows[col], dtype=np.float32)[keep]
            numerics.append(np.where(np.isnan(v), self.means[j], v)[:, None])
        return np.concatenate([onehot] * self.repeats + numerics, axis=1)

    def fit_transform(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        return self.fit(rows).transform(rows)

    def transform_single(self, category: str,
                         numeric_values: Sequence[float]) -> np.ndarray:
        """One row's features (the ``infer_single_row`` path)."""
        rows = {self.category_col: np.array([category], dtype=object)}
        for col, v in zip(self.numeric_cols, numeric_values):
            rows[col] = np.array([v], dtype=np.float32)
        return self.transform(rows)
