"""PyTorch port, the TFRecord data plane on the CPU against the JAX
package: the codec's bytes (records, Examples, crc32c) equal the JAX
codec's; shards written by either package are read by the other into
the same batches (shuffled and not, striped over processes); and
``mlm_batches`` gives the JAX batches bit for bit from one seed."""

import numpy as np
import pytest

from pyspark_tf_gke_tpu.data import codec as jcodec
from pyspark_tf_gke_tpu.data import mlm as jmlm
from pyspark_tf_gke_tpu.data import native_tfrecord as jtf
from pyspark_tf_gke_tpu_torch.data import codec as tcodec
from pyspark_tf_gke_tpu_torch.data import mlm as tmlm
from pyspark_tf_gke_tpu_torch.data import tfrecord as ttf
from pyspark_tf_gke_tpu_torch.train.bert_finetune import shard_schema

SEQ = 12


def _arrays(n=90, vocab=96, seed=0):
    """The ETL-bridge contract: ids, a padded attention mask, labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, SEQ)).astype(np.int64)
    ids[:, 0] = 101  # [CLS]
    lengths = rng.integers(4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int64)
    ids = np.where(mask == 1, ids, 0)
    return {"input_ids": ids, "attention_mask": mask,
            "label": rng.integers(0, 2, n).astype(np.int64)}


def test_codec_bytes_equal_the_jax_codec():
    rng = np.random.default_rng(1)
    schema = {"f": ("float", (3, 2)), "i": ("int", (5,)),
              "b": ("bytes", (4,)), "s": ("int", ())}
    for _ in range(5):
        row = {"f": rng.standard_normal((3, 2)).astype(np.float32),
               "i": rng.integers(-2**40, 2**40, 5),
               "b": rng.integers(0, 256, 4).astype(np.uint8),
               "s": np.int64(rng.integers(0, 9))}
        ex = tcodec.encode_example(schema, row)
        assert ex == jcodec.encode_example(schema, row)
        rec = tcodec.encode_record(ex)
        assert rec == jcodec.encode_record(ex)
        back = tcodec.parse_example(schema, ex)
        for k in schema:
            np.testing.assert_array_equal(back[k], np.asarray(row[k]))
    data = rng.integers(0, 256, 1000).astype(np.uint8).tobytes()
    assert tcodec.crc32c(data) == jcodec.crc32c(data)
    assert tcodec.masked_crc32c(data) == jcodec.masked_crc32c(data)
    assert tcodec.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check


def _read(mod, pattern, shuffle, n_batches, **kw):
    if mod is jtf:
        # the native pool reads in file order with one thread and
        # interleaves its threads' rows otherwise (its docstring)
        kw["nthreads"] = 1
    it = mod.read_tfrecord_batches(pattern, shard_schema(SEQ), 8,
                                   shuffle=shuffle, seed=5, **kw)
    return [next(it) for _ in range(n_batches)]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_shards_cross_packages(tmp_path, writer, shuffle):
    arrays = _arrays()
    prefix = str(tmp_path / "shards" / "train")
    write = (ttf.write_tfrecord_shards if writer == "port"
             else jtf.write_tfrecord_shards)
    paths = write(arrays, prefix, num_shards=3)
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        f"train-0000{i}-of-00003.tfrecord" for i in range(3)]
    if writer == "port":  # byte for byte the JAX writer's files
        jpaths = jtf.write_tfrecord_shards(arrays, str(tmp_path / "j" / "t"),
                                           num_shards=3)
        for a, b in zip(paths, jpaths):
            assert open(a, "rb").read() == open(b, "rb").read()
    pattern = f"{prefix}-*.tfrecord"
    # 90 rows in batches of 8: 11 a pass, the 12th and later wrap around
    ours = _read(ttf, pattern, shuffle, 14)
    ref = _read(jtf, pattern, shuffle, 14, process_index=0,
                process_count=1)
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    # the files stripe over processes as the JAX reader stripes them
    for index in range(2):
        ours = _read(ttf, pattern, shuffle, 3, process_index=index,
                     process_count=2)
        ref = _read(jtf, pattern, shuffle, 3, process_index=index,
                    process_count=2)
        for a, b in zip(ours, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_reader_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(ttf.read_tfrecord_batches(str(tmp_path / "none-*"),
                                       shard_schema(SEQ), 4))
    prefix = str(tmp_path / "one")
    ttf.write_tfrecord_shards(_arrays(n=10), prefix, num_shards=1)
    with pytest.raises(ValueError, match="shards <"):
        next(ttf.read_tfrecord_batches(f"{prefix}-*", shard_schema(SEQ), 4,
                                       process_index=1, process_count=2))


def test_mlm_batches_equal_the_jax_batches():
    arrays = _arrays(n=64)
    raw = [{"input_ids": arrays["input_ids"][i:i + 16].astype(np.int32),
            "attention_mask": arrays["attention_mask"][i:i + 16]
            .astype(np.int32)} for i in range(0, 64, 16)]
    ours = list(tmlm.mlm_batches(iter(raw), 96, seed=7, mask_prob=0.3))
    ref = list(jmlm.mlm_batches(iter(raw), 96, seed=7, mask_prob=0.3))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        for k in ("input_ids", "attention_mask", "mlm_labels"):
            np.testing.assert_array_equal(a[k], b[k])
    labels = np.concatenate([b["mlm_labels"] for b in ours])
    picked = labels != tmlm.IGNORE_INDEX
    assert 0 < picked.mean() < 0.5
    # padding and the special ids are never picked
    mask = np.concatenate([b["attention_mask"] for b in ours])
    assert not (picked & (mask == 0)).any()
    ids = np.concatenate([r["input_ids"] for r in raw])
    assert not (picked & np.isin(ids, tmlm.DEFAULT_SPECIAL_IDS)).any()
