"""PyTorch port, the reference-parity data plane against the JAX package:
the synthetic generators (CSV text, PNG bytes, ``clean_labels.jsonl``,
arrays) byte for byte, ``load_csv`` (local, ``memory://`` and
``http://localhost``), ``list_labeled_images``' filtering rules,
``resize_bilinear_tf``, ``load_image``, ``make_image_arrays``,
``train_validation_split``, ``host_shard`` and ``BatchIterator`` (every
batch, ``fast_forward`` at and within epoch boundaries) exactly, and
``chip_smoke.py``'s copies of ``tools/loss_parity.py``'s arrays.
"""

import functools
import http.server
import importlib
import json
import os
import threading
from pathlib import Path

import fsspec
import numpy as np
import pytest
import torch

import chip_smoke
from pyspark_tf_gke_tpu.data import csv_loader as jcsv
from pyspark_tf_gke_tpu.data import images as jimg
from pyspark_tf_gke_tpu.data import pipeline as jpipe
from pyspark_tf_gke_tpu.data import synthetic as jsyn
from pyspark_tf_gke_tpu_torch.data import csv_loader as tcsv
from pyspark_tf_gke_tpu_torch.data import images as timg
from pyspark_tf_gke_tpu_torch.data import pipeline as tpipe
from pyspark_tf_gke_tpu_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _loss_parity():
    """``tools/loss_parity.py``, imported without keeping the environment
    defaults it sets for its TensorFlow run."""
    saved = dict(os.environ)
    try:
        return importlib.import_module("tools.loss_parity")
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _same_arrays(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_arrays(a[k], b[k])
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_arrays(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [1337, 7])
def test_csv_generators_write_the_same_bytes(tmp_path, seed):
    for name, kw in (("make_synthetic_csv", {"rows": 700}),
                     ("make_reference_csv", {"rows": 3000})):
        j, t = tmp_path / f"j-{name}.csv", tmp_path / f"t-{name}.csv"
        getattr(jsyn, name)(str(j), seed=seed, **kw)
        getattr(tsyn, name)(str(t), seed=seed, **kw)
        assert j.read_bytes() == t.read_bytes(), name


def test_image_generator_writes_the_same_pngs_and_labels(tmp_path):
    jsyn.make_synthetic_image_dataset(str(tmp_path / "j"), num_images=6,
                                      height=24, width=40, seed=3)
    tsyn.make_synthetic_image_dataset(str(tmp_path / "t"), num_images=6,
                                      height=24, width=40, seed=3)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "clean_labels.jsonl" in names and len(names) == 7
    for name in names:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes()), name


def test_array_generators_match():
    _same_arrays(jsyn.synthetic_classification_arrays(300, 4, 5, seed=2),
                 tsyn.synthetic_classification_arrays(300, 4, 5, seed=2))
    _same_arrays(jsyn.synthetic_tokens(3, 16, 99, seed=4),
                 tsyn.synthetic_tokens(3, 16, 99, seed=4))


def test_chip_smoke_copies_the_parity_arrays():
    loss_parity = _loss_parity()
    _same_arrays(loss_parity.make_spot_arrays(5, 24, 40, seed=1337),
                 chip_smoke.make_spot_arrays(5, 24, 40, seed=1337))
    _same_arrays(loss_parity.make_health_arrays(600),
                 chip_smoke.make_health_arrays(600))


EDGE_CSV = """edition,report_type,measure_name,state_name,subpopulation,value,lower_ci,upper_ci,source,source_date
2021,a,m,s,Male,1.5,1.0,2.0,x,2019
2021,a,m,s,,1.5,1.0,2.0,x,2019
2021,a,m,s,Female,NaN,1.0,2.0,x,2019
2021,a,m,s,Female,1.0,nan,2.0,x,2019
2021,a,m,s,Female,abc,1.0,2.0,x,2019
2021,a,m,s,Female,3.0,,2.0,x,2019
2021,a,m,s,Female
2021,a,m,s,Adults,7.25,7.0,7.5,"quoted, source",2019,extra
2021,a,m,s, Female ,4.0,3.5,4.5,x,2019
2021,a,m,s,Male,inf,1.0,2.0,x,2019
"""


def test_load_csv_matches_on_local_files(tmp_path):
    for name, text in (("edge.csv", EDGE_CSV), ("ref.csv", None),
                       ("syn.csv", None)):
        path = tmp_path / name
        if name == "ref.csv":
            tsyn.make_reference_csv(str(path), rows=2500)
        elif name == "syn.csv":
            tsyn.make_synthetic_csv(str(path), rows=900, missing_rate=0.3)
        else:
            path.write_text(text)
        _same_arrays(tuple(jcsv.load_csv(str(path))[:2]),
                     tuple(tcsv.load_csv(str(path))[:2]))
        assert jcsv.load_csv(str(path))[2] == tcsv.load_csv(str(path))[2]
    j = jcsv.load_csv(str(tmp_path / "edge.csv"),
                      numeric_features=["value"], label_col="state_name")
    t = tcsv.load_csv(str(tmp_path / "edge.csv"),
                      numeric_features=["value"], label_col="state_name")
    _same_arrays(tuple(j[:2]), tuple(t[:2]))
    assert j[2] == t[2]
    empty = tmp_path / "empty.csv"
    empty.write_text(EDGE_CSV.splitlines()[0] + "\n2021,a,m,s,,1,1,1,x,y\n")
    with pytest.raises(RuntimeError, match="No valid rows"):
        tcsv.load_csv(str(empty))


def test_load_csv_reads_object_store_and_http_urls(tmp_path):
    tsyn.make_synthetic_csv(str(tmp_path / "d.csv"), rows=200)
    data = (tmp_path / "d.csv").read_bytes()
    want = jcsv.load_csv(str(tmp_path / "d.csv"))
    fs = fsspec.filesystem("memory")
    fs.pipe("/p9/d.csv", data)
    try:
        got = tcsv.load_csv("memory://p9/d.csv")
        _same_arrays(tuple(want[:2]), tuple(got[:2]))
        assert want[2] == got[2]
    finally:
        fs.rm("/p9", recursive=True)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(tmp_path))
    handler.log_message = lambda *a, **k: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/d.csv"
        got = tcsv.load_csv(url)
        _same_arrays(tuple(want[:2]), tuple(got[:2]))
        _same_arrays(tuple(jcsv.load_csv(url)[:2]), tuple(got[:2]))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def _labeled_dir(root: Path) -> Path:
    tsyn.make_synthetic_image_dataset(str(root), num_images=5, height=20,
                                      width=28, seed=5)
    lines = (root / "clean_labels.jsonl").read_text().splitlines()
    extra = [
        "not json",
        "",
        json.dumps({"image": "img_0001.txt", "point": {"x_px": 1, "y_px": 2}}),
        json.dumps({"image": "missing.png", "point": {"x_px": 1, "y_px": 2}}),
        json.dumps({"image": "img_0002.png", "point": {"x_px": 3}}),
        json.dumps({"image": "img_0003.png"}),
        json.dumps({"image": "  ", "point": {"x_px": 1, "y_px": 2}}),
        json.dumps({"image": "IMG_UPPER.PNG", "point": {"x_px": 4.5,
                                                         "y_px": 6}}),
    ]
    (root / "img_0001.txt").write_text("x")
    (root / "IMG_UPPER.PNG").write_bytes((root / "img_0000.png").read_bytes())
    (root / "clean_labels.jsonl").write_text(
        "\n".join(lines[:2] + extra + lines[2:]) + "\n")
    return root


def test_labeled_image_listing_and_decoding_match(tmp_path):
    root = _labeled_dir(tmp_path / "imgs")
    jp, jt = jimg.list_labeled_images(str(root))
    tp, tt = timg.list_labeled_images(str(root))
    assert jp == tp and len(tp) == 6
    _same_arrays(jt, tt)
    assert timg.count_images(str(root)) == jimg.count_images(str(root)) == 6
    assert timg.SUPPORTED_EXTS == jimg.SUPPORTED_EXTS
    for size in ((20, 28), (13, 9), (40, 61)):
        _same_arrays(jimg.load_image(tp[0], *size),
                     timg.load_image(tp[0], *size))
    idx = np.array([4, 0, 2])
    _same_arrays(jimg.make_image_arrays(str(root), (16, 24), idx),
                 timg.make_image_arrays(str(root), (16, 24), idx))
    _same_arrays(jimg.make_image_arrays(str(root), (20, 28)),
                 timg.make_image_arrays(str(root), (20, 28)))
    with pytest.raises(RuntimeError, match="clean_labels.jsonl not found"):
        timg.list_labeled_images(str(tmp_path))


@pytest.mark.parametrize("shape,out", [((17, 23, 3), (8, 11)),
                                       ((8, 11, 3), (17, 23)),
                                       ((10, 10, 1), (10, 31)),
                                       ((32, 40, 3), (32, 40))])
def test_resize_bilinear_matches(shape, out):
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    _same_arrays(jimg.resize_bilinear_tf(img, *out),
                 timg.resize_bilinear_tf(img, *out))


@pytest.mark.parametrize("n,split,seed", [(100, 0.2, 1337), (5, 0.2, 1),
                                          (7, 0.0, 3), (10, 0.99, 4)])
def test_split_and_host_shard_match(n, split, seed):
    _same_arrays(jpipe.train_validation_split(n, split, seed),
                 tpipe.train_validation_split(n, split, seed))
    a, b = np.arange(n * 2).reshape(n, 2), np.arange(n)
    for index, count in ((0, 1), (1, 3), (2, 3)):
        _same_arrays(jpipe.host_shard(a, b, process_index=index,
                                      process_count=count),
                     tpipe.host_shard(a, b, process_index=index,
                                      process_count=count))
    _same_arrays(tpipe.host_shard(a, b), (a, b))


def _draws(it, k):
    return [it.__next__() for _ in range(k)]


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, True),
                                          (True, False)])
def test_batch_iterator_matches_with_fast_forward(shuffle, drop):
    n, bs = 23, 5
    arrays = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
              "y": np.arange(n, dtype=np.int32)}
    kw = dict(shuffle=shuffle, seed=11, drop_remainder=drop)
    j = jpipe.BatchIterator(arrays, bs, **kw)
    t = tpipe.BatchIterator(arrays, bs, **kw)
    assert j.steps_per_epoch == t.steps_per_epoch
    spe = t.steps_per_epoch
    _same_arrays(_draws(j, 3 * spe + 2), _draws(t, 3 * spe + 2))
    # at an epoch boundary, within an epoch, and past several epochs
    for consumed in (0, spe, 2, spe + 3, 3 * spe, 3 * spe + 1):
        j.fast_forward(consumed)
        t.fast_forward(consumed)
        _same_arrays(_draws(j, spe + 2), _draws(t, spe + 2))
        # a fast-forwarded iterator continues as one that drew the batches
        fresh = tpipe.BatchIterator(arrays, bs, **kw)
        _draws(fresh, consumed)
        _same_arrays(_draws(fresh, spe),
                     _draws(tpipe.BatchIterator(arrays, bs, **kw)
                            .fast_forward(consumed), spe))
    with pytest.raises(ValueError, match="consumed_batches"):
        t.fast_forward(-1)
    with pytest.raises(ValueError, match="batch_size"):
        tpipe.BatchIterator(arrays, n + 1)
    with pytest.raises(ValueError, match="mismatch"):
        tpipe.BatchIterator({"x": arrays["x"], "y": arrays["y"][:-1]}, bs)
