"""CSV data path (the port's copy of
``pyspark_tf_gke_tpu/data/csv_loader.py``), with the reference loader's
semantics, on which loss parity depends:

* a row is dropped when the label column is missing or empty, when any
  numeric feature is missing, empty or "nan" (any case), or when a field
  fails to parse;
* the label vocabulary is ``sorted(set(labels))``;
* features come back float32, label indices int32.

``open_text`` reads a local file, an ``http(s)://`` URL or an
object-store URL (``gs://``; ``memory://`` in the tests) through
``utils/fs.py``.
"""

from __future__ import annotations

import csv
import io
from typing import List, Optional, Tuple
from urllib.request import urlopen

import numpy as np

from pyspark_tf_gke_tpu_torch.utils.fs import fs_open, is_remote


def open_text(path_or_url: str) -> io.TextIOBase:
    """Open a local file, an HTTP(S) URL or an fsspec URL as text."""
    if path_or_url.startswith(("http://", "https://")):
        return io.TextIOWrapper(urlopen(path_or_url), encoding="utf-8")
    if is_remote(path_or_url):
        return io.TextIOWrapper(fs_open(path_or_url, "rb"), encoding="utf-8")
    return open(path_or_url, "r", encoding="utf-8")


def load_csv(
    source: str,
    numeric_features: Optional[List[str]] = None,
    label_col: str = "subpopulation",
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Parse a CSV into (features float32, label indices int32, sorted vocab)."""
    if numeric_features is None:
        numeric_features = ["value", "lower_ci", "upper_ci"]

    features: List[List[float]] = []
    labels_raw: List[str] = []

    with open_text(source) as fh:
        for row in csv.DictReader(fh):
            try:
                label = row.get(label_col, "").strip()
                if not label:
                    continue
                feats = []
                for col in numeric_features:
                    value = row.get(col, "").strip()
                    if value == "" or value.lower() == "nan":
                        break
                    feats.append(float(value))
                else:
                    features.append(feats)
                    labels_raw.append(label)
            except (AttributeError, ValueError):
                continue  # a short row (None fields) or an unparsable value

    if not features:
        raise RuntimeError("No valid rows were parsed from the dataset.")

    vocab = sorted(set(labels_raw))
    index_map = {s: i for i, s in enumerate(vocab)}
    y_idx = np.array([index_map[s] for s in labels_raw], dtype=np.int32)
    return np.asarray(features, dtype=np.float32), y_idx, vocab
