"""PyTorch port, the native ETL chain against the JAX package on the CPU.

Exact: ``string_index``, ``FeaturePipeline``'s matrix (the reference
CSV's 18,154 rows, an unseen category, imputation, ``transform_single``),
the knobs' environment parsing, ``read_columns``, the k-means++ centres
and ``write_partition_rows``' shard bytes.

KMeans on blobs and on the whole 18,154-row reference CSV (the JAX fit
takes about 2 s here): ``n_iter`` equal, and the port's fit the same at
1 and 4 threads (its products accumulate in f64); centres within 1e-4
absolute + 1e-5 relative and ``cost`` within 1e-4 relative (JAX's
products and sums accumulate in f32); ``predict`` equal wherever a row's two
nearest centres are more than 1e-3 relative apart (a nearer tie can
break either way under another summation order; the rows that differ
are reported). ``silhouette_score`` within 1e-6 of JAX's and of a
naive O(n^2) one. ``KMeansWorkloadTPU.run`` and the bootstrap's summary
equal JAX's, less their ``seconds`` fields and paths (the silhouette,
rounded to 4 places, within 1e-4). No fallback: ``cuda`` without a
card raises, ``mesh=`` takes a ``DeviceMesh`` only (the fit over ranks
is ``tests/test_torch_p11_models.py``'s), a Spark or MySQL step the JAX
module would run names P12.
"""

import contextlib
import io
import json
import sys
import types

import numpy as np
import pytest
import torch

from pyspark_tf_gke_tpu.etl import bootstrap as jbootstrap
from pyspark_tf_gke_tpu.etl import feature_pipeline as jfp
from pyspark_tf_gke_tpu.etl import kmeans as jkm
from pyspark_tf_gke_tpu.etl import knobs as jknobs
from pyspark_tf_gke_tpu.etl import tfrecord_bridge as jbridge
from pyspark_tf_gke_tpu.etl import workload as jworkload
from pyspark_tf_gke_tpu_torch import etl as tetl
from pyspark_tf_gke_tpu_torch.data.synthetic import (make_reference_csv,
                                                     make_synthetic_csv)
from pyspark_tf_gke_tpu_torch.etl import bootstrap, knobs, tfrecord_bridge
from pyspark_tf_gke_tpu_torch.etl import feature_pipeline as tfp
from pyspark_tf_gke_tpu_torch.etl import kmeans as tkm
from pyspark_tf_gke_tpu_torch.etl import workload

torch.set_num_threads(1)


def _blobs(n_per=64, k=4, d=3, spread=0.4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, d))
    x = np.concatenate([c + rng.normal(0, spread, (n_per, d))
                        for c in centers])
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference CSV's columns through both packages' readers."""
    path = make_reference_csv(str(tmp_path_factory.mktemp("ref") / "h.csv"))
    return jworkload.read_columns(path), workload.read_columns(path)


def _same_columns(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype == object:
            assert a[k].tolist() == b[k].tolist(), k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_string_index_and_read_columns(tmp_path, reference):
    rng = np.random.default_rng(0)
    vals = [str(v) for v in rng.integers(0, 12, 500)] + ["b", "a"]
    assert tfp.string_index(vals) == jfp.string_index(vals)
    assert tfp.string_index(["b", "a", "b", "c", "b", "a"]) == {
        "b": 0, "a": 1, "c": 2}
    _same_columns(*reference)
    path = str(tmp_path / "s.csv")
    make_synthetic_csv(path, rows=120, missing_rate=0.3)
    _same_columns(jworkload.read_columns(path), workload.read_columns(path))


def test_feature_pipeline_matrix_equals_jax(reference, monkeypatch):
    monkeypatch.delenv("MEASURE_NAME_WEIGHT", raising=False)
    jcols, cols = reference
    jpipe, pipe = jfp.FeaturePipeline(), tfp.FeaturePipeline()
    want, got = jpipe.fit_transform(jcols), pipe.fit_transform(cols)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert pipe.index_map == jpipe.index_map
    np.testing.assert_array_equal(pipe.means, jpipe.means)
    for cat, nums in (("Asthma", [10, 17, 15]), ("never-seen", [1, 2, 3]),
                      ("Cancer", [np.nan, 1.0, 2.0])):
        np.testing.assert_array_equal(pipe.transform_single(cat, nums),
                                      jpipe.transform_single(cat, nums))
    assert pipe.transform_single("never-seen", [1, 2, 3])[
        0, :pipe.onehot_width].sum() == 0
    # nulls dropped, a NaN imputed with the kept rows' mean, dropLast
    rows = {"measure_name": np.array(["x", "y", "x", "z", None], object),
            "value": np.array([1, 2, np.nan, 4, 5], np.float32),
            "lower_ci": np.array([0, 1, 2, 3, 4], np.float32),
            "upper_ci": np.array([2, 3, 4, 5, 6], np.float32)}
    for repeats in (1, 3):
        got = tfp.FeaturePipeline(repeats=repeats).fit_transform(rows)
        np.testing.assert_array_equal(
            got, jfp.FeaturePipeline(repeats=repeats).fit_transform(rows))
    assert got.shape == (4, 3 * 2 + 3)
    assert np.isclose(got[2, 6], 7.0 / 3)


@pytest.mark.parametrize("weight,k", [(None, None), ("3", "4"),
                                      ("-2", "junk"), ("x", "1")])
def test_knobs_parse_the_environment_as_jax(monkeypatch, weight, k):
    for var, value in (("MEASURE_NAME_WEIGHT", weight), ("KMEANS_K", k)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    assert knobs.measure_weight() == jknobs.measure_weight()
    assert knobs.kmeans_k() == jknobs.kmeans_k()
    assert tfp.FeaturePipeline().repeats == jfp.FeaturePipeline().repeats
    for r in (0, 2, 5):
        assert knobs.assemble_feature_cols(r) == \
            jknobs.assemble_feature_cols(r)
    assert (knobs.KMEANS_SEED, knobs.KMEANS_MAX_ITER, knobs.DEFAULT_K,
            knobs.NUMERIC_COLS) == (jknobs.KMEANS_SEED,
                                    jknobs.KMEANS_MAX_ITER,
                                    jknobs.DEFAULT_K, jknobs.NUMERIC_COLS)


def _agree(jmodel, model, x, what):
    """The fit's state and answers against JAX's (the module docstring's
    tolerances)."""
    assert model.n_iter == jmodel.n_iter, what
    np.testing.assert_allclose(model.centers, jmodel.centers, atol=1e-4,
                               rtol=1e-5, err_msg=what)
    assert model.cost(x) == pytest.approx(jmodel.cost(x), rel=1e-4), what
    got, want = model.predict(x), jmodel.predict(x)
    differ = np.flatnonzero(got != want)
    if differ.size:
        d = np.sort(np.asarray(tkm._sq_dists(
            torch.from_numpy(x[differ]), torch.from_numpy(model.centers))),
            axis=1)
        margins = (d[:, 1] - d[:, 0]) / np.maximum(d[:, 0], 1e-12)
        print(f"{what}: {differ.size} assignments differ, relative "
              f"margins {margins.tolist()}")
        assert (margins < 1e-3).all(), what


def test_kmeans_matches_jax_on_blobs():
    x = _blobs()
    for k, max_iter in ((4, 100), (6, 3), (3, 1)):
        jm = jkm.KMeans(k=k, max_iter=max_iter, seed=1)
        tm = tkm.KMeans(k=k, max_iter=max_iter, seed=1, device="cpu")
        np.testing.assert_array_equal(tm._init_centers(x),
                                      jm._init_centers(x))
        jm.fit(x)
        tm.fit(x)
        _agree(jm, tm, x, f"blobs k={k} max_iter={max_iter}")
    assert tm.n_iter == 1  # max_iter bounds the count
    labels = tkm.KMeans(k=4, seed=1, device="cpu").fit(x).predict(x)
    assert len(np.unique(labels)) == 4
    with pytest.raises(ValueError, match="rows < k"):
        tkm.KMeans(k=10, device="cpu").fit(x[:5])
    with pytest.raises(RuntimeError, match="fit"):
        tkm.KMeans(device="cpu").predict(x)


def test_kmeans_matches_jax_on_the_reference_csv(reference):
    """All 18,154 rows, k 25, the bootstrap's 100 iterations."""
    jcols, cols = reference
    x = tfp.FeaturePipeline(repeats=5).fit_transform(cols)
    jm = jkm.KMeans(k=25, max_iter=100, seed=1)
    tm = tkm.KMeans(k=25, max_iter=100, seed=1, device="cpu")
    np.testing.assert_array_equal(tm._init_centers(x), jm._init_centers(x))
    jm.fit(x)
    tm.fit(x)
    assert 1 < tm.n_iter < 100  # converged, and not at once
    _agree(jm, tm, x, "reference CSV")
    # f64 accumulation: the fit does not follow the BLAS's thread count
    torch.set_num_threads(4)
    try:
        again = tkm.KMeans(k=25, max_iter=100, seed=1, device="cpu").fit(x)
    finally:
        torch.set_num_threads(1)
    assert again.n_iter == tm.n_iter
    np.testing.assert_array_equal(again.centers, tm.centers)


def _naive_silhouette(x, labels):
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1).astype(np.float64)
    out = []
    for i in range(len(x)):
        own = labels == labels[i]
        if own.sum() <= 1:
            out.append(0.0)
            continue
        a = d[i, own].sum() / (own.sum() - 1)
        b = min(d[i, labels == c].mean() for c in np.unique(labels)
                if c != labels[i])
        out.append((b - a) / max(a, b))
    return float(np.mean(out))


def test_silhouette_matches_jax_and_naive():
    x = _blobs(n_per=40, k=3, spread=2.0, seed=4)
    labels = tkm.KMeans(k=3, seed=1, device="cpu").fit(x).predict(x)
    got = tkm.silhouette_score(x, labels, block=32, device="cpu")
    assert got == pytest.approx(jkm.silhouette_score(x, labels, block=32),
                                abs=1e-6)
    assert got == pytest.approx(_naive_silhouette(x, labels), abs=1e-5)
    # a singleton cluster scores 0
    labels[0] = 3
    assert tkm.silhouette_score(x, labels, device="cpu") == pytest.approx(
        jkm.silhouette_score(x, labels), abs=1e-6)


def test_write_partition_rows_bytes_equal_jax(tmp_path):
    rows = [{"value": 1.5, "name": "Asthma", "raw": b"\x00\xff",
             "label": 3, "neg": -7, "ids": [1, 2, 300],
             "features": [0.25, 1e-3, -2.0]},
            {"value": 7, "name": "", "raw": b"", "label": 0, "neg": 0,
             "ids": [], "features": [3.0]}]
    cols = ["value", "name", "raw", "neg", "ids", "features"]
    for row in rows:
        assert tfrecord_bridge.example_bytes(row) == \
            jbridge.example_bytes(row)
    (ours,) = tfrecord_bridge.write_partition_rows(
        1, iter(rows), str(tmp_path / "t" ), cols, "label", num_shards=3)
    (theirs,) = jbridge.write_partition_rows(
        1, iter(rows), str(tmp_path / "j"), cols, "label", num_shards=3)
    assert ours.endswith("t-00001-of-00003.tfrecord")
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert tfrecord_bridge.tfrecord_frame(b"abc") == \
        jbridge.tfrecord_frame(b"abc")


def _strip(summary):
    """A summary less its timings and paths."""
    if isinstance(summary, dict):
        return {k: _strip(v) for k, v in summary.items()
                if k not in ("seconds", "path")}
    return summary


def test_workload_run_equals_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "d.csv")
    make_synthetic_csv(path, rows=500)
    monkeypatch.delenv("MEASURE_NAME_WEIGHT", raising=False)
    monkeypatch.setenv("RUN_INFERENCE", "true")
    jw = jworkload.KMeansWorkloadTPU(k=6, max_iter=50)
    tw = workload.KMeansWorkloadTPU(k=6, max_iter=50, device="cpu")
    want = jw.run(jworkload.read_columns(path))
    got = tw.run(workload.read_columns(path))
    assert got.keys() == want.keys()
    for key in ("n_rows", "k", "n_iter"):
        assert got[key] == want[key], key
    assert got["cost"] == pytest.approx(want["cost"], rel=1e-4)
    assert got["silhouette"] == pytest.approx(want["silhouette"], abs=1e-6)
    for label, num in zip(workload.INFERENCE_LABELS,
                          workload.INFERENCE_NUMS):
        assert tw.infer_single_row(label, num) == jw.infer_single_row(
            label, num)
    with pytest.raises(RuntimeError, match="run"):
        workload.KMeansWorkloadTPU(device="cpu").infer_single_row()


def _summary(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bootstrap_summary_equals_jax(tmp_path, monkeypatch):
    for var in ("MEASURE_NAME_WEIGHT", "KMEANS_K"):
        monkeypatch.delenv(var, raising=False)
    argv = ["--rows", "600", "--k", "8", "--max-iter", "20",
            "--silhouette-sample", "256", "--shards", "3"]
    jrc, want = _summary(jbootstrap.run,
                         argv + ["--out", str(tmp_path / "jax")])
    rc, got = _summary(bootstrap.run, argv + ["--out", str(tmp_path / "port"),
                                              "--device", "cpu"])
    assert rc == jrc == 0
    assert got["value"] == 1 and got["bridge"]["roundtrip_ok"]
    sil, jsil = (s["native_chain"].pop("silhouette") for s in (got, want))
    assert sil == pytest.approx(jsil, abs=1e-4)
    assert _strip(got) == _strip(want)
    assert set(got["native_chain"]) | {"silhouette"} == set(
        want["native_chain"]) | {"silhouette"}
    assert "skipped" in got["mysql_load"] and "skipped" in got["spark_chain"]
    assert (tmp_path / "port" / "clusters-00002-of-00003.tfrecord").read_bytes() \
        == (tmp_path / "jax" / "clusters-00002-of-00003.tfrecord").read_bytes()


def test_no_fallback_and_the_unported_steps(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="is_available"):
        tkm.KMeans()
    with pytest.raises(RuntimeError, match="is_available"):
        tkm.silhouette_score(_blobs(), np.zeros(256, int))
    with pytest.raises(RuntimeError, match="is_available"):
        bootstrap.run(["--out", str(tmp_path / "b")])
    with pytest.raises(TypeError, match="DeviceMesh"):
        tkm.KMeans(device="cpu", mesh=object())
    base = ["--out", str(tmp_path / "c"), "--rows", "60", "--k", "3",
            "--device", "cpu"]
    monkeypatch.setattr(bootstrap, "_spark_unavailable", lambda: None)
    with pytest.raises(NotImplementedError, match="P12"):
        bootstrap.run(base)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "mysql", types.ModuleType("mysql"))
    monkeypatch.setitem(sys.modules, "mysql.connector",
                        types.ModuleType("mysql.connector"))
    with pytest.raises(NotImplementedError, match="P12"):
        bootstrap.run(base + ["--mysql-host", "127.0.0.1"])
    assert tetl.__all__ == ["FeaturePipeline", "KMeans", "silhouette_score"]
    assert tetl.KMeans is tkm.KMeans
