"""The native KMeans workload (counterpart of
``pyspark_tf_gke_tpu/etl/workload.py``; the reference's
``KMeansWorkload.main``): CSV -> the feature pipeline -> KMeans (k 25,
seed 1, maxIter 1000) on the device -> the silhouette -> single-row
inferences. The class keeps the JAX name, so that the two workloads'
logs and summaries line up.
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Dict, Optional, Union

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.etl.feature_pipeline import FeaturePipeline
from pyspark_tf_gke_tpu_torch.etl.kmeans import KMeans, silhouette_score
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("etl.workload")

INFERENCE_LABELS = ["Able-Bodied", "Asthma", "Avoided Care Due to Cost",
                    "Cancer", "Cardiovascular Diseases", "Child Poverty",
                    "Premature Death"]
INFERENCE_NUMS = [0, 10, 20, 30, 40, 50, 60]


def read_columns(csv_path: str) -> Dict[str, np.ndarray]:
    """CSV -> column dict: the numerics f32 with NaN where missing, the
    rest object arrays with None where empty."""
    numeric = {"value", "lower_ci", "upper_ci"}
    cols: Dict[str, list] = {}
    with open(csv_path, "r", encoding="utf-8") as fh:
        for row in csv.DictReader(fh):
            for key, v in row.items():
                v = (v or "").strip()
                if key in numeric:
                    cols.setdefault(key, []).append(
                        float(v) if v and v.lower() != "nan" else np.nan)
                else:
                    cols.setdefault(key, []).append(v if v else None)
    return {key: np.asarray(values, dtype=np.float32 if key in numeric
                            else object)
            for key, values in cols.items()}


class KMeansWorkloadTPU:
    def __init__(self, k: int = 25, seed: int = 1, max_iter: int = 1000,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        self.pipeline: Optional[FeaturePipeline] = None
        self.model: Optional[KMeans] = None
        self.k, self.seed, self.max_iter = k, seed, max_iter
        self.device, self.mesh = device, mesh

    def run(self, columns: Dict[str, np.ndarray],
            evaluate: bool = True) -> dict:
        line = "=" * 80
        logger.info(line)
        logger.info("TPU-native KMeans workload")
        logger.info(line)
        self.pipeline = FeaturePipeline()
        features = self.pipeline.fit_transform(columns)
        logger.info("feature matrix: %s (onehot width %d x %d repeats + %d "
                    "numerics)", features.shape, self.pipeline.onehot_width,
                    self.pipeline.repeats, len(self.pipeline.numeric_cols))
        k = min(self.k, len(features) - 1)
        self.model = KMeans(k=k, seed=self.seed, max_iter=self.max_iter,
                            device=self.device, mesh=self.mesh).fit(features)
        result = {"n_rows": int(len(features)), "k": k,
                  "n_iter": self.model.n_iter,
                  "cost": self.model.cost(features)}
        if evaluate:
            labels = self.model.predict(features)
            result["silhouette"] = silhouette_score(features, labels,
                                                    device=self.device)
        logger.info("kmeans: %s", result)
        if os.environ.get("RUN_INFERENCE", "true").lower() in (
                "1", "true", "yes", "y"):
            for label, num in zip(INFERENCE_LABELS, INFERENCE_NUMS):
                pred = self.infer_single_row(label, num)
                logger.info("inference %r value=%d -> cluster %s", label,
                            num, pred)
        return result

    def infer_single_row(self, entry_str: str = "Able-Bodied",
                         entry_num: int = 0) -> int:
        """The reference's single-row schema: (measure_name, value,
        value + 7, value + 5)."""
        if self.pipeline is None or self.model is None:
            raise RuntimeError("run() first")
        row = self.pipeline.transform_single(
            entry_str, [entry_num, entry_num + 7, entry_num + 5])
        return int(self.model.predict(row)[0])

    @classmethod
    def main(cls, csv_path: str,
             device: Union[str, torch.device] = "cuda") -> dict:
        return cls(device=device).run(read_columns(csv_path))


if __name__ == "__main__":
    # python -m pyspark_tf_gke_tpu_torch.etl.workload CSV [cuda|cpu]
    KMeansWorkloadTPU.main(sys.argv[1],
                           sys.argv[2] if len(sys.argv) > 2 else "cuda")
