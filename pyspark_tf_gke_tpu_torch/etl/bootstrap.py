"""One-command data-plane bootstrap, the native chain (counterpart of
``pyspark_tf_gke_tpu/etl/bootstrap.py``):

    python -m pyspark_tf_gke_tpu_torch.etl.bootstrap --out DIR [--device cpu]

which, in order:

1. generates the reference-schema dataset at reference scale
   (``data/synthetic.py::make_reference_csv``, 18,154 rows), or takes
   ``--csv``;
2. records the MySQL load as the JAX module records it when it skips it
   (no ``--mysql-host``, or no ``mysql.connector``); where the JAX
   module would load, it raises (P12);
3. records the Spark chain as skipped where the JAX module skips it (no
   ``pyspark``, or no JVM); where it would run, it raises (P12); then
   runs the native chain: ``FeaturePipeline`` -> ``KMeans`` on
   ``--device`` -> the silhouette over a 4096-row sample drawn by
   ``default_rng(0)``;
4. writes the features and cluster labels as TFRecord shards through the
   bridge's writer (``etl/tfrecord_bridge.py``) and reads them back with
   ``data/tfrecord.py::read_tfrecord_batches``, checking the row count.

The JSON summary (the JAX module's keys) is the last stdout line. The
run is on ``cuda`` unless ``--device cpu`` (the JAX module defaults to
its CPU platform; the port runs on the card unless asked).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np


def _mysql_load(host: Optional[str], summary: dict) -> None:
    if not host:
        summary["mysql_load"] = {
            "skipped": "no --mysql-host given (reference flow: "
                       "kubectl port-forward svc/mysql-external 3306)"}
        return
    try:
        import mysql.connector  # noqa: F401
    except ImportError:
        summary["mysql_load"] = {
            "skipped": "mysql-connector-python not installed"}
        return
    raise NotImplementedError(
        "the MySQL load (etl/load_csv_mysql.py) is not ported to "
        "pyspark_tf_gke_tpu_torch (ROADMAP, P12)")


def _spark_unavailable() -> Optional[str]:
    try:
        import pyspark  # noqa: F401
    except ImportError:
        return "pyspark not installed"
    if not (os.environ.get("JAVA_HOME") or shutil.which("java")):
        return "no JVM (java not on PATH, JAVA_HOME unset)"
    return None


def _spark_chain(summary: dict) -> None:
    why_not = _spark_unavailable()
    if why_not is None:
        raise NotImplementedError(
            "the Spark chain (etl/kmeans_spark.py) is not ported to "
            "pyspark_tf_gke_tpu_torch (ROADMAP, P12)")
    summary["spark_chain"] = {"skipped": why_not}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="working directory for the generated artifacts")
    ap.add_argument("--csv", default=None,
                    help="existing reference-schema CSV (default: generate)")
    ap.add_argument("--rows", type=int, default=18154,
                    help="generator row count (reference scale)")
    ap.add_argument("--k", type=int, default=None,
                    help="clusters (default: etl.knobs.kmeans_k -> 25)")
    ap.add_argument("--max-iter", type=int, default=100,
                    help="Lloyd iterations (reference: 1000; 100 converges "
                    "on this data)")
    ap.add_argument("--silhouette-sample", type=int, default=4096,
                    help="rows sampled for the O(N^2) silhouette")
    ap.add_argument("--mysql-host", default=None)
    ap.add_argument("--shards", type=int, default=16,
                    help="TFRecord shards (reference JDBC partitions: 16)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where KMeans and the silhouette run")
    return ap.parse_args(argv)


def run(argv=None) -> int:
    args = parse_args(argv)
    from pyspark_tf_gke_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    summary: dict = {"metric": "etl_bootstrap"}

    # 1. dataset
    t0 = time.time()
    if args.csv:
        csv_path = args.csv
        summary["dataset"] = {"path": csv_path, "generated": False}
    else:
        from pyspark_tf_gke_tpu_torch.data.synthetic import make_reference_csv

        csv_path = make_reference_csv(
            os.path.join(args.out, "health.csv"), rows=args.rows)
        summary["dataset"] = {"path": csv_path, "generated": True,
                              "rows": args.rows,
                              "seconds": round(time.time() - t0, 1)}

    # 2-3a. the MySQL load and the Spark chain (P12), disclosed
    _mysql_load(args.mysql_host, summary)
    _spark_chain(summary)

    # 3b. the native chain
    from pyspark_tf_gke_tpu_torch.etl.feature_pipeline import FeaturePipeline
    from pyspark_tf_gke_tpu_torch.etl.kmeans import KMeans, silhouette_score
    from pyspark_tf_gke_tpu_torch.etl.knobs import kmeans_k
    from pyspark_tf_gke_tpu_torch.etl.workload import read_columns

    t0 = time.time()
    cols = read_columns(csv_path)
    feats = FeaturePipeline().fit_transform(cols)
    k = args.k or kmeans_k()
    km = KMeans(k=k, max_iter=args.max_iter, seed=1, device=device)
    km.fit(feats)
    labels = km.predict(feats)
    rng = np.random.default_rng(0)
    sample = rng.choice(len(feats), min(args.silhouette_sample, len(feats)),
                        replace=False)
    sil = silhouette_score(feats[sample], labels[sample], device=device)
    summary["native_chain"] = {
        "rows_in": int(len(cols["measure_name"])),
        "rows_kept": int(feats.shape[0]),
        "feature_width": int(feats.shape[1]),
        "k": k, "iters": int(km.n_iter),
        "silhouette": round(float(sil), 4),
        "silhouette_sample": int(len(sample)),
        "seconds": round(time.time() - t0, 1),
    }

    # 4. bridge: features + labels -> TFRecord shards -> read back
    from pyspark_tf_gke_tpu_torch.data.tfrecord import read_tfrecord_batches
    from pyspark_tf_gke_tpu_torch.etl.tfrecord_bridge import (
        write_partition_rows)

    t0 = time.time()
    prefix = os.path.join(args.out, "clusters")
    n = feats.shape[0]
    written = []
    for idx in range(args.shards):
        part = [{"features": feats[i].tolist(), "cluster": int(labels[i])}
                for i in range(idx, n, args.shards)]
        written += list(write_partition_rows(
            idx, part, prefix, cols=["features", "cluster"],
            num_shards=args.shards))
    # batch_size=1: the reader drops the remainder, which must not eat
    # the tail rows of the exact-count check
    seen = 0
    for batch in read_tfrecord_batches(
            f"{prefix}-*-of-{args.shards:05d}.tfrecord",
            {"features": ("float", (feats.shape[1],)),
             "cluster": ("int", ())},
            batch_size=1, shuffle=False, repeat=False):
        seen += len(batch["cluster"])
    summary["bridge"] = {
        "shards": len(written), "rows_written": n, "rows_read": seen,
        "roundtrip_ok": seen == n,
        "seconds": round(time.time() - t0, 1),
    }
    ok = summary["bridge"]["roundtrip_ok"] and bool(np.isfinite(sil))
    summary["value"] = 1 if ok else 0
    summary["unit"] = "bootstrap_ok"
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
