"""PyTorch port, three options the JAX package takes, against it on the
CPU: ``peak_flops`` (``ContinuousEngine``, ``BundleServer``,
``--peak-flops`` / ``SERVE_PEAK_FLOPS``) arms ``/metrics``' ``serve_mfu``
gauge as the JAX server's does; ``batch_admit=False`` admits one
request at a time with the JAX engine's tokens; ``lm_pretrain
--tokenizer <local Hugging Face directory>`` trains with the JAX run's
vocabulary and batches and exports a bundle naming the tokenizer as the
JAX export does. Tokens are compared exactly (f32)."""

import dataclasses
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models.causal_lm import CausalLM, CausalLMConfig
from pyspark_tf_gke_tpu.train.continuous import (
    ContinuousEngine as JaxEngine)
from pyspark_tf_gke_tpu_torch.train.continuous import ContinuousEngine
from pyspark_tf_gke_tpu_torch.train import export as texport
from tests.test_torch_train import _corpus, _hf_tokenizer

torch.set_num_threads(1)

CFG = dict(vocab_size=259, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_seq_len=128, dtype=jnp.float32,
           kv_page_size=16, kv_num_pages=32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One JAX init exported by each package (byte tokenizer)."""
    from pyspark_tf_gke_tpu.train import export as jexport

    cfg = CausalLMConfig(**CFG)
    jmodel = CausalLM(cfg)
    params = jax.device_get(nn.meta.unbox(jmodel.init(
        jax.random.key(5), jnp.ones((1, 8), jnp.int32))["params"]))
    root = tmp_path_factory.mktemp("opts")
    jdir = jexport.export_serving_bundle(cfg, params, str(root / "j"),
                                         quantize=False)
    fields = dataclasses.asdict(cfg)
    fields["dtype"] = "float32"
    tdir = texport.export_serving_bundle(
        texport.config_from_dict(fields), texport.params_from_flax(params),
        str(root / "t"), quantize=False)
    return jmodel, params, jdir, tdir


def _serve_mfu(mod_serve, mod_metrics, bundle, peak, **kw):
    """``serve_mfu`` from ``/metrics`` after two generate requests."""
    server = mod_serve.BundleServer(bundle, continuous_slots=2,
                                    continuous_chunk=4, peak_flops=peak,
                                    registry=mod_metrics.MetricsRegistry(),
                                    **kw)
    httpd = mod_serve.start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for prompt in ("paged attention", "hopper kernels"):
            req = urllib.request.Request(
                url + "/v1/generate", data=json.dumps(
                    {"prompts": [prompt], "max_new_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
        with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        # the JAX server stops through its continuous front
        stop = getattr(server, "shutdown", None) or server._front.shutdown
        stop()
    line = next(ln for ln in text.splitlines()
                if ln.startswith("serve_mfu "))
    return float(line.split()[1])


@pytest.mark.parametrize("peak", [0.0, 1e9], ids=["off", "armed"])
def test_peak_flops_arms_serve_mfu_as_the_jax_server(bundles, peak):
    from pyspark_tf_gke_tpu.obs import metrics as jmetrics
    from pyspark_tf_gke_tpu.train import serve as jserve
    from pyspark_tf_gke_tpu_torch.obs import metrics as tmetrics
    from pyspark_tf_gke_tpu_torch.train import serve as tserve

    _, _, jdir, tdir = bundles
    want = _serve_mfu(jserve, jmetrics, jdir, peak)
    got = _serve_mfu(tserve, tmetrics, tdir, peak, device="cpu")
    assert (got > 0) == (want > 0) == (peak > 0)


def test_peak_flops_flag_and_environment(monkeypatch):
    from pyspark_tf_gke_tpu_torch.train.serve import parse_args

    assert parse_args(["--bundle", "b"]).peak_flops == 0.0
    assert parse_args(["--bundle", "b", "--peak-flops", "989e12"]
                      ).peak_flops == 989e12
    monkeypatch.setenv("SERVE_PEAK_FLOPS", "5e14")
    assert parse_args(["--bundle", "b"]).peak_flops == 5e14


def test_batch_admit_off_equals_the_jax_engine(bundles):
    jmodel, params, _, tdir = bundles
    tmodel = texport.load_serving_bundle(tdir, "cpu")[0]
    rng = np.random.default_rng(40)
    specs = [(rng.integers(1, 259, int(n)), int(m))
             for n, m in [(9, 6), (21, 4), (5, 9), (14, 7), (30, 5)]]
    kw = dict(num_slots=3, chunk=4)

    def run(engine):
        rids = [engine.submit(p, max_new_tokens=m) for p, m in specs]
        out = dict(engine.run_until_drained())
        return [out[r] for r in rids], engine.stats["batch_admits"]

    want, jax_batched = run(JaxEngine(jmodel, params, batch_admit=False,
                                      **kw))
    got, batched = run(ContinuousEngine(tmodel, batch_admit=False, **kw))
    assert got == want
    assert batched == jax_batched == 0
    # on by default: the same tokens, admitted in batches
    got_on, batched_on = run(ContinuousEngine(tmodel, **kw))
    assert got_on == want and batched_on >= 2


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return _hf_tokenizer(tmp_path_factory.mktemp("hf") / "tok")


def test_lm_pretrain_takes_a_local_hf_tokenizer(tmp_path, hf_dir):
    from pyspark_tf_gke_tpu.data.text import get_tokenizer as jax_tokenizer
    from pyspark_tf_gke_tpu.data.text import lm_batches as jax_lm_batches
    from pyspark_tf_gke_tpu.train.lm_pretrain import main as jax_main
    from pyspark_tf_gke_tpu_torch.data.text import get_tokenizer, lm_batches
    from pyspark_tf_gke_tpu_torch.train.lm_pretrain import main

    pattern = str(_corpus(tmp_path) / "*.txt")
    ours, ref = get_tokenizer(hf_dir), jax_tokenizer(hf_dir)
    assert ours.vocab_size == ref.vocab_size
    a = lm_batches(pattern, ours, 32, 4, seed=3)
    b = jax_lm_batches(pattern, ref, 32, 4, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        assert set(x) == set(y)
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])
    common = ["--data-pattern", pattern, "--tokenizer", hf_dir,
              "--seq-len", "32", "--hidden-size", "32", "--num-layers", "1",
              "--num-heads", "2", "--intermediate-size", "64", "--epochs",
              "1", "--steps-per-epoch", "2", "--batch-size", "8",
              "--compute-dtype", "float32", "--export-dense"]
    jax_main(common + ["--output-dir", str(tmp_path / "jax"),
                       "--export-bundle", str(tmp_path / "jb")])
    hist = main(common + ["--output-dir", str(tmp_path / "port"),
                          "--export-bundle", str(tmp_path / "tb"),
                          "--device", "cpu"])
    assert all(np.isfinite(hist["loss"]))
    jmeta = json.loads((tmp_path / "jb" / "config.json").read_text())
    tmeta = json.loads((tmp_path / "tb" / "config.json").read_text())
    assert tmeta["tokenizer"] == jmeta["tokenizer"] == hf_dir
    model, _, meta = texport.load_serving_bundle(str(tmp_path / "tb"), "cpu")
    assert model.cfg.vocab_size == ref.vocab_size
    # a hub name would need a download: refused, naming its ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(common[:2] + ["--tokenizer", "gpt2", "--device", "cpu"])
