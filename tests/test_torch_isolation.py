"""PyTorch port, isolation: the package (P10's modules among them),
``chip_smoke.py`` and ``kernel_probe.py`` import no JAX and nothing of
the JAX package; the device is explicit and nothing falls back to the
CPU (P10's entry points too); the kernels build
for ``sm_90a`` into the ignored build directory (checked without running
``nvcc``).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLMConfig,
                                                       require_flash)
from pyspark_tf_gke_tpu_torch.ops import kernels
from pyspark_tf_gke_tpu_torch.ops.layernorm import fused_layernorm
from pyspark_tf_gke_tpu_torch.train.export import (config_from_dict,
                                                   config_to_dict)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "pyspark_tf_gke_tpu"}


TRAINING_MODULES = ("utils/fs.py", "data/text.py", "data/pipeline.py",
                    "train/losses.py", "train/state.py", "train/harness.py",
                    "train/checkpoint.py", "train/resilience.py",
                    "train/trainer.py", "train/lm_pretrain.py",
                    "ops/fused_matmul.py", "ops/fused_conv3.py",
                    "models/resnet.py", "ops/chunked_ce.py",
                    "etl/text_bridge.py", "evaluate/lm_eval.py")
SERVING_MODULES = ("train/continuous.py", "train/serve.py",
                   "train/kv_transfer.py", "obs/stepstats.py",
                   "models/speculative.py", "models/lanes.py",
                   "train/spec_fixture.py", "ops/graphs.py",
                   "obs/metrics.py", "obs/events.py", "obs/trace.py",
                   "obs/runtime.py", "obs/export.py", "chaos/inject.py",
                   "models/beam_search.py", "ops/int8_matmul.py",
                   "ops/quant.py")
BERT_MODULES = ("utils/seeding.py", "data/codec.py", "data/tfrecord.py",
                "data/mlm.py", "models/bert.py", "train/bert_finetune.py",
                "ops/attention.py")
P9_MODULES = ("utils/config.py", "data/synthetic.py", "data/csv_loader.py",
              "data/images.py", "models/__init__.py", "models/mlp.py",
              "models/cnn.py", "train/cli.py", "evaluate/image_checker.py")
P10_MODULES = ("models/moe.py", "models/vit.py", "etl/__init__.py",
               "etl/knobs.py", "etl/feature_pipeline.py", "etl/kmeans.py",
               "etl/tfrecord_bridge.py", "etl/workload.py",
               "etl/bootstrap.py")


def _port_files():
    pkg = REPO / "pyspark_tf_gke_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)
    assert len(files) > 10
    rel = {p.relative_to(pkg).as_posix() for p in files}
    assert set(TRAINING_MODULES) <= rel
    assert set(SERVING_MODULES) <= rel
    assert set(BERT_MODULES) <= rel
    assert set(P9_MODULES) <= rel
    assert set(P10_MODULES) <= rel
    return files + [REPO / "chip_smoke.py", REPO / "kernel_probe.py"]


def test_no_forbidden_import_in_source():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (
                    f"{path.relative_to(REPO)} imports {name}")


def test_importing_the_server_loads_no_jax():
    # a subprocess: this test process has imported jax already (conftest)
    code = ("import sys, pyspark_tf_gke_tpu_torch.train.serve, chip_smoke\n"
            "import pyspark_tf_gke_tpu_torch.train.lm_pretrain\n"
            "import pyspark_tf_gke_tpu_torch.models.resnet\n"
            "import pyspark_tf_gke_tpu_torch.train.bert_finetune\n"
            "import pyspark_tf_gke_tpu_torch.etl.text_bridge\n"
            "import pyspark_tf_gke_tpu_torch.evaluate.lm_eval\n"
            "import pyspark_tf_gke_tpu_torch.train.cli\n"
            "import pyspark_tf_gke_tpu_torch.evaluate.image_checker\n"
            "import pyspark_tf_gke_tpu_torch.models.vit\n"
            "import pyspark_tf_gke_tpu_torch.etl.bootstrap\n"
            "import pyspark_tf_gke_tpu_torch.etl.workload\n"
            "import pyspark_tf_gke_tpu_torch.etl.tfrecord_bridge\n"
            "from pyspark_tf_gke_tpu_torch.models import build_model\n"
            "build_model('mlp', num_classes=3, input_dim=3, device='cpu')\n"
            "build_model('cnn', image_size=(16, 16), device='cpu')\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cuda_without_a_card_raises():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernels.library()


def test_p10_entry_points_run_on_cuda_unless_asked():
    """ViT, the MoE FFN, KMeans, the silhouette and the bootstrap build
    on ``cuda`` by default, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    from pyspark_tf_gke_tpu_torch.etl import bootstrap
    from pyspark_tf_gke_tpu_torch.etl.kmeans import KMeans, silhouette_score
    from pyspark_tf_gke_tpu_torch.models.bert import BertConfig
    from pyspark_tf_gke_tpu_torch.models.moe import MoELayer
    from pyspark_tf_gke_tpu_torch.models.vit import ViTClassifier

    cfg = BertConfig(hidden_size=32, num_layers=1, num_heads=4,
                     intermediate_size=64)
    for build in (lambda: ViTClassifier(cfg, 3, patch_size=8,
                                        image_size=(16, 16)),
                  lambda: MoELayer(2, 32, 64), lambda: KMeans(k=2),
                  lambda: silhouette_score(np.zeros((4, 2)), np.arange(4)),
                  lambda: bootstrap.run(["--out", "unused"])):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    assert bootstrap.parse_args(["--out", "x"]).device == "cuda"


def test_wrapper_refuses_a_non_cpu_non_cuda_tensor():
    x = torch.empty(2, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_layernorm(x, torch.ones(32, device="meta"),
                        torch.zeros(32, device="meta"))


def test_use_flash_false_is_refused_on_cuda_only():
    cfg = CausalLMConfig(use_flash=False)
    with pytest.raises(ValueError, match="use_flash=False"):
        require_flash(cfg, torch.device("cuda"))
    require_flash(cfg, torch.device("cpu"))
    for flag in (None, True):
        require_flash(CausalLMConfig(use_flash=flag), torch.device("cuda"))


def test_float16_is_not_ported():
    fields = config_to_dict(CausalLMConfig())
    with pytest.raises(NotImplementedError, match="float16"):
        config_from_dict({**fields, "dtype": "float16"})
    with pytest.raises(NotImplementedError, match="float16"):
        config_to_dict(CausalLMConfig(dtype=torch.float16))
    with pytest.raises(TypeError, match="float16"):
        kernels.dtype_code(torch.float16, "layernorm")


def test_build_targets_sm90a_into_the_ignored_build_dir():
    compiles, link = kernels.build_commands("nvcc")
    assert {Path(c[c.index("-c") + 1]).name for c in compiles} == {
        "layernorm.cu", "layernorm_bwd.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "flash_attention_simt.cu",
        "paged_attention.cu", "fused_matmul.cu", "fused_conv3.cu",
        "int8_matmul.cu"}
    for cmd in compiles + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    for cmd in compiles:
        assert "-O3" in cmd and "-fPIC" in cmd
    assert "-shared" in link
    out = Path(link[link.index("-o") + 1])
    assert out.parent == kernels.BUILD_DIR
    assert kernels.BUILD_DIR == REPO / "pyspark_tf_gke_tpu_torch" / "_build"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "pyspark_tf_gke_tpu_torch/_build/" in ignored


def test_kernel_probe_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(REPO / "kernel_probe.py"),
                          "graph"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0 and '"ok"' not in res.stdout
