"""PyTorch port, ``evaluate/lm_eval.py`` against the JAX module on the
CPU, and ``train/serve.py``'s remote bundles.

One JAX bundle (f32, dense and int8), carried into the port with
``params_from_flax``: bundle-mode perplexity equals the JAX
``lm_eval``'s (the same eos-packed rows, f32 sums in another order:
1e-5 relative), greedy and beam samples are the same text; ``--endpoint``
against one in-process port ``BundleServer`` gives the JAX
``endpoint_eval``'s JSON (keys and values, less the server's latency);
a bundle named by a ``memory://`` URL is pulled by ``_resolve_bundle``
and served.
"""

import json
import shutil
import threading
from pathlib import Path

import fsspec
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.evaluate import lm_eval as jeval
from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.train import export as jexport
from pyspark_tf_gke_tpu_torch.evaluate import lm_eval as teval
from pyspark_tf_gke_tpu_torch.train import export as texport
from pyspark_tf_gke_tpu_torch.train.serve import (BundleServer,
                                                  _resolve_bundle,
                                                  start_http_server)

torch.set_num_threads(1)

WORDS = "the flash kernel runs on hopper with paged attention and int8".split()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("heldout")
    rng = np.random.default_rng(0)
    for f in range(2):
        docs = [" ".join(rng.choice(WORDS, rng.integers(8, 30)))
                for _ in range(12)]
        (root / f"part-{f}.txt").write_text("\n\n".join(docs) + "\n")
    return str(root / "*.txt")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("bundles")
    cfg = jlm.CausalLMConfig(vocab_size=259, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_seq_len=64, dtype=jnp.float32)
    params = nn.meta.unbox(jlm.CausalLM(cfg).init(
        jax.random.key(4), jnp.ones((1, 8), jnp.int32))["params"])
    out = {}
    for quantize in (False, True):
        name = "int8" if quantize else "dense"
        jdir = jexport.export_serving_bundle(cfg, params,
                                             str(root / f"jax-{name}"),
                                             quantize=quantize)
        _, jparams, meta = jexport.load_serving_bundle(jdir)
        tdir = texport.export_serving_bundle(
            texport.config_from_dict(meta["config"]),
            texport.params_from_flax(jax.device_get(jparams)),
            str(root / f"torch-{name}"), quantize=quantize)
        out[name] = (jdir, tdir)
    return out


def _common(corpus):
    return ["--data-pattern", corpus, "--batches", "3", "--batch-size", "2",
            "--seq-len", "32", "--prompt", "the flash", "--prompt", "int8",
            "--max-new-tokens", "6"]


@pytest.mark.parametrize("kind", ["dense", "int8"])
@pytest.mark.parametrize("beams", [1, 3])
def test_bundle_mode_matches_jax(bundles, corpus, kind, beams, capsys):
    jdir, tdir = bundles[kind]
    flags = _common(corpus) + ["--num-beams", str(beams)]
    want = jeval.main(["--bundle", jdir] + flags)
    got = teval.main(["--bundle", tdir, "--device", "cpu"] + flags)
    assert set(got) == set(want)
    assert got["tokens"] == want["tokens"] > 0
    np.testing.assert_allclose(got["mean_nll"], want["mean_nll"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)
    assert got["quantized"] == want["quantized"] == (kind == "int8")
    assert [s["completion"] for s in got["samples"]] == [
        s["completion"] for s in want["samples"]]
    if beams > 1:
        np.testing.assert_allclose(
            [s["beam_score"] for s in got["samples"]],
            [s["beam_score"] for s in want["samples"]], rtol=1e-4)
    # one JSON line on stdout, as the JAX module prints
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == got


def test_bundle_mode_checks_seq_len_and_the_modes(bundles):
    _, tdir = bundles["dense"]
    with pytest.raises(ValueError, match="exceeds the bundle's max_seq_len"):
        teval.main(["--bundle", tdir, "--device", "cpu", "--seq-len", "65",
                    "--data-pattern", "x"])
    with pytest.raises(SystemExit):
        teval.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def served(bundles):
    _, tdir = bundles["int8"]
    server = BundleServer(tdir, device="cpu", continuous_slots=2,
                          continuous_chunk=4)
    httpd = start_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    server.shutdown()
    thread.join(10)
    assert not thread.is_alive()


def test_endpoint_mode_gives_the_jax_json(served, corpus):
    flags = ["--endpoint", served, "--data-pattern", corpus, "--batches",
             "2", "--batch-size", "3", "--prompt", "the flash",
             "--max-new-tokens", "5"]
    want = jeval.main(flags)
    got = teval.main(flags)
    for sample in got["samples"] + want["samples"]:
        sample.pop("latency_ms")  # the server's wall clock
    assert got == want
    assert set(got) == {"endpoint", "perplexity", "mean_nll", "tokens",
                        "samples"}
    assert np.isfinite(got["mean_nll"]) and got["tokens"] > 0


def test_remote_bundle_is_pulled_and_served(bundles):
    _, tdir = bundles["int8"]
    fs = fsspec.filesystem("memory")
    url = "memory://lmeval-bundles/int8"
    for path in Path(tdir).iterdir():
        fs.pipe(f"/lmeval-bundles/int8/{path.name}", path.read_bytes())
    local = None
    try:
        local = _resolve_bundle(url)
        assert local != url and Path(local).is_dir()
        for path in Path(tdir).iterdir():
            assert (Path(local) / path.name).read_bytes() == \
                path.read_bytes()
        assert _resolve_bundle(tdir) == tdir  # local paths pass through
        server = BundleServer(local, device="cpu")
        try:
            out = server.generate(["int8"], max_new_tokens=3)[0]
            assert out["completion"].startswith("int8")
        finally:
            server.shutdown()
    finally:
        fs.rm("/lmeval-bundles", recursive=True)
        if local is not None:
            shutil.rmtree(local, ignore_errors=True)
