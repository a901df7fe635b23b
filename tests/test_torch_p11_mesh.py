"""PyTorch port, the training mesh's pure half (``parallel/mesh.py``,
``parallel/sharding.py``, ``parallel/distributed.py``) against the JAX
package on the conftest's 8 fake CPU devices, with no process group:

* the rank arrays of ``make_mesh``, ``make_hybrid_mesh`` and
  ``mesh_from_spec`` (wildcards, ``force_contiguous``, grouping by
  node) equal the JAX ``Mesh.devices`` ids, and the same inputs raise
  the same errors;
* ``fsdp_spec`` over a spread of shapes, meshes and ``min_size``
  values, and ``mesh_extent_for``;
* the placement of every CausalLM, BERT (with MoE layers) and ViT
  parameter equals ``logical_shardings`` of the JAX model's abstract
  init on ``dp=2,fsdp=2,tp=2``;
* the rows each rank takes equal ``batch_sharding``'s;
* the coordinator helpers;
* the serve wire's multi-host flags (``--tp``, ``--num-processes`` over
  1) raise, naming P11b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pyspark_tf_gke_tpu.models import BertConfig as JaxBertConfig
from pyspark_tf_gke_tpu.models import ViTClassifier as JaxViT
from pyspark_tf_gke_tpu.models import bert as jbert
from pyspark_tf_gke_tpu.models import causal_lm as jlm
from pyspark_tf_gke_tpu.parallel import distributed as jdist
from pyspark_tf_gke_tpu.parallel import mesh as jmesh
from pyspark_tf_gke_tpu.parallel import sharding as jshard
from pyspark_tf_gke_tpu_torch.models import bert as tbert
from pyspark_tf_gke_tpu_torch.models import causal_lm as tlm
from pyspark_tf_gke_tpu_torch.models.vit import ViTClassifier
from pyspark_tf_gke_tpu_torch.parallel import distributed as tdist
from pyspark_tf_gke_tpu_torch.parallel import mesh as tmesh
from pyspark_tf_gke_tpu_torch.parallel import sharding as tshard

torch.set_num_threads(1)


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _raises_alike(jax_call, port_call):
    with pytest.raises(ValueError) as jerr:
        jax_call()
    with pytest.raises(ValueError) as terr:
        port_call()
    assert str(terr.value) == str(jerr.value)


MESHES = [None, {"dp": 8}, {"dp": 2, "fsdp": 4}, {"fsdp": -1, "tp": 2},
          {"dp": 2, "fsdp": 2, "tp": 2}, {"tp": 2, "sp": -1},
          {"pp": 2, "ep": 2, "dp": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_make_mesh_rank_order_matches_jax(devices, axes):
    want = _ids(jmesh.make_mesh(axes, devices[:8]))
    got = tmesh.mesh_array(axes, list(range(8)))
    assert got.shape == want.shape and (got == want).all()


BAD_MESHES = [{"xx": 2}, {"dp": -1, "fsdp": -1}, {"fsdp": 3, "dp": -1},
              {"dp": 3}]


@pytest.mark.parametrize("axes", BAD_MESHES, ids=str)
def test_make_mesh_errors_match_jax(devices, axes):
    _raises_alike(lambda: jmesh.make_mesh(axes, devices[:8]),
                  lambda: tmesh.mesh_array(axes, list(range(8))))


HYBRID = [({"dp": 2}, {"fsdp": 2, "tp": 2}), ({"dp": 2}, None),
          ({"dp": -1}, {"tp": 2}), ({"dp": 2, "fsdp": 2}, {"tp": 2}),
          ({"fsdp": 2}, {"fsdp": 2, "dp": 2}), ({"dp": 2}, {"fsdp": -1})]


@pytest.mark.parametrize("dcn,ici", HYBRID, ids=str)
def test_make_hybrid_mesh_rank_order_matches_jax(devices, dcn, ici):
    want = _ids(jmesh.make_hybrid_mesh(dcn, ici, devices[:8],
                                       force_contiguous=True))
    for nodes in (None, [0] * 8):  # one node: contiguous, as on the CPU
        got = tmesh.hybrid_mesh_array(dcn, ici, list(range(8)), nodes)
        assert (got == want).all()
    got = tmesh.hybrid_mesh_array(dcn, ici, list(range(8)), [0, 1] * 4,
                                  force_contiguous=True)
    assert (got == want).all()


@pytest.mark.parametrize("dcn,ici", HYBRID[:4], ids=str)
def test_hybrid_mesh_groups_ranks_by_node(devices, dcn, ici):
    """Ranks of two nodes interleaved: each slice is one node's ranks,
    as JAX groups devices by slice (here: the devices listed node by
    node, then grouped contiguously)."""
    n_slices = int(np.prod(list(dcn.values()))) if -1 not in dcn.values() \
        else 8 // int(np.prod(list((ici or {}).values())))
    nodes = [r % n_slices for r in range(8)]
    order = sorted(range(8), key=lambda r: (nodes[r], r))
    want = _ids(jmesh.make_hybrid_mesh(
        dcn, ici, [devices[r] for r in order], force_contiguous=True))
    got = tmesh.hybrid_mesh_array(dcn, ici, list(range(8)), nodes)
    assert (got == want).all()


BAD_HYBRID = [({"zz": 2}, None), ({"dp": -1}, {"tp": -1}),
              ({"dp": 3}, {"tp": 2}), ({"dp": 2}, {"tp": 3})]


@pytest.mark.parametrize("dcn,ici", BAD_HYBRID, ids=str)
def test_make_hybrid_mesh_errors_match_jax(devices, dcn, ici):
    _raises_alike(
        lambda: jmesh.make_hybrid_mesh(dcn, ici, devices[:8],
                                       force_contiguous=True),
        lambda: tmesh.hybrid_mesh_array(dcn, ici, list(range(8))))


@pytest.mark.parametrize("ici,dcn", [({"fsdp": 4}, {"dp": 2}),
                                     ({"tp": 2, "fsdp": -1}, None),
                                     (None, None)], ids=str)
def test_mesh_from_spec_matches_jax(devices, ici, dcn):
    want = _ids(jmesh.mesh_from_spec(ici, dcn, devices[:8]) if not dcn
                else jmesh.make_hybrid_mesh(dcn, ici, devices[:8],
                                            force_contiguous=True))
    got = (tmesh.hybrid_mesh_array(dcn, ici, list(range(8))) if dcn
           else tmesh.mesh_array(ici or None, list(range(8))))
    assert (got == want).all()


SHAPES = [(1024, 1024), (3, 3, 64, 128), (512,), (1000, 768), (7,),
          (256, 256, 4), (4, 4), (96, 96), (6, 10)]


@pytest.mark.parametrize("axes", [{"dp": 2, "fsdp": 4}, {"fsdp": 8},
                                  {"dp": 8}, {"fsdp": 2, "tp": 4}], ids=str)
@pytest.mark.parametrize("min_size", [0, 16, 1024, jshard.DEFAULT_MIN_SIZE])
def test_fsdp_spec_matches_jax(devices, axes, min_size):
    jm = jmesh.make_mesh(axes, devices[:8])
    for shape in SHAPES:
        want = tuple(jshard.fsdp_spec(shape, jm, min_size))
        assert tshard.fsdp_spec(shape, axes, min_size) == want, shape
    assert tshard.DEFAULT_MIN_SIZE == jshard.DEFAULT_MIN_SIZE


@pytest.mark.parametrize("axes", [{"dp": 2, "fsdp": 2, "tp": 2},
                                  {"sp": 4, "dp": 2}, {"dp": 8}], ids=str)
def test_mesh_extent_for_matches_jax(devices, axes):
    jm = jmesh.make_mesh(axes, devices[:8])
    for name, _ in jshard.LOGICAL_RULES:
        assert tshard.mesh_extent_for(name, axes) == \
            jshard.mesh_extent_for(name, jm), name
    assert tshard.mesh_extent_for("heads", None) == 1
    assert tshard.LOGICAL_RULES == jshard.LOGICAL_RULES


def _jax_specs(model, *args):
    abstract = jax.eval_shape(lambda r: model.init(r, *args),
                              jax.random.key(0))["params"]
    mesh = jmesh.make_mesh({"dp": 2, "fsdp": 2, "tp": 2}, jax.devices()[:8])
    shardings = nn.logical_to_mesh_sharding(
        nn.get_partition_spec(abstract), mesh, jshard.LOGICAL_RULES)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for path, sharding in flat:
        spec = list(sharding.spec)
        while spec and spec[-1] is None:
            spec.pop()
        out["/".join(k.key for k in path)] = tuple(spec)
    return out


LM = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
          intermediate_size=128, max_seq_len=16)
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=16,
            num_experts=4, moe_every=2)


@pytest.mark.parametrize("case", ["lm", "llama_gqa", "bert_moe", "vit"])
def test_logical_placements_match_jax(devices, case):
    sizes = {"dp": 2, "fsdp": 2, "tp": 2}
    ids = np.zeros((2, 8), np.int32)
    if case in ("lm", "llama_gqa"):
        extra = ({"pos_embedding": "rope", "norm": "rmsnorm",
                  "ffn": "swiglu", "num_kv_heads": 2}
                 if case == "llama_gqa" else {})
        want = _jax_specs(jlm.CausalLM(jlm.CausalLMConfig(
            **LM, **extra, dtype=jnp.float32)), ids)
        with torch.device("meta"):
            model = tlm.CausalLM(tlm.CausalLMConfig(**LM, **extra),
                                 param_dtype=torch.float32)
    elif case == "bert_moe":
        want = _jax_specs(jbert.BertForPretraining(JaxBertConfig(**BERT)),
                          ids)
        with torch.device("meta"):
            model = tbert.BertForPretraining(tbert.BertConfig(**BERT),
                                             param_dtype=torch.float32)
    else:
        cfg = {**BERT, "num_experts": 0}
        images = np.zeros((2, 16, 16, 3), np.float32)
        want = _jax_specs(JaxViT(JaxBertConfig(**cfg), num_classes=10,
                                 patch_size=8), images)
        model = ViTClassifier(tbert.BertConfig(**cfg), 10, patch_size=8,
                              image_size=(16, 16), device="meta")
    got = tshard.logical_shardings(model, sizes)
    assert got == want
    assert tshard.model_shardings(model, sizes) == want


def test_unannotated_models_take_fsdp_spec():
    from pyspark_tf_gke_tpu_torch.models.mlp import MLPClassifier

    model = MLPClassifier(num_classes=3, input_dim=64, hidden=(512, 256),
                          device="cpu")
    specs = tshard.model_shardings(model, {"fsdp": 2}, min_size=1024)
    shapes = {k.replace(".", "/"): tuple(p.shape)
              for k, p in model.named_parameters()}
    assert specs == {k: tshard.fsdp_spec(s, {"fsdp": 2}, 1024)
                     for k, s in shapes.items()}
    assert any(specs.values())


def test_uneven_splits():
    """An uneven vocab split over tp stays whole; an uneven mlp split
    over tp raises; an uneven fsdp split stays whole."""
    sizes = {"fsdp": 2, "tp": 2}
    assert tshard.logical_spec(("embed", "vocab"), (64, 61), sizes) == (
        "fsdp",)
    assert tshard.logical_spec(("embed", "vocab"), (63, 64), sizes) == (
        None, "tp")
    with pytest.raises(ValueError, match="mlp"):
        tshard.logical_spec(("embed", "mlp"), (64, 63), sizes)


@pytest.mark.parametrize("axes", [{"dp": 2, "fsdp": 2, "tp": 2},
                                  {"dp": 8}, {"fsdp": 4, "sp": 2},
                                  {"tp": 2, "fsdp": 2, "dp": 2}], ids=str)
def test_batch_rows_match_batch_sharding(devices, axes):
    jm = jmesh.make_mesh(axes, devices[:8])
    rows = 32
    index_map = jmesh.batch_sharding(jm).devices_indices_map((rows,))
    array = tmesh.mesh_array(axes, list(range(8)))
    for device, (want,) in index_map.items():
        got = tmesh.batch_block(array, device.id, rows)
        assert (got.start, got.stop) == (want.start or 0, want.stop or rows)


def test_batch_rows_need_divisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.batch_block(tmesh.mesh_array({"dp": 8}, list(range(8))), 0, 12)


@pytest.mark.parametrize("host", ["tpu-worker-3", "tpu-worker-12\n", "solo",
                                  "a-b-0"])
def test_process_ordinal_matches_jax(host):
    assert tdist.process_ordinal_from_hostname(host) == \
        jdist.process_ordinal_from_hostname(host)


@pytest.mark.parametrize("addr", ["10.0.0.1", "10.0.0.1:1234", "host.local",
                                  "[::1]", "fe80::1", "http://x",
                                  "300.1.1.1", "a b"])
def test_validate_ipv4_matches_jax(addr):
    def outcome(fn):
        try:
            fn(addr)
            return None
        except RuntimeError as e:
            return str(e)

    assert outcome(tdist.validate_ipv4) == outcome(jdist.validate_ipv4)


@pytest.mark.parametrize("args", [("", 8476, "tpu-worker"),
                                  ("10.1.2.3", 99, "j"),
                                  ("10.1.2.3:77", 99, "j"), ("", 5, "trainer")])
def test_build_coordinator_address_matches_jax(args):
    assert tdist.build_coordinator_address(*args) == \
        jdist.build_coordinator_address(*args)
    assert (tdist.DEFAULT_PORT, tdist.DEFAULT_JOB_NAME) == (
        jdist.DEFAULT_PORT, jdist.DEFAULT_JOB_NAME)


def test_initialize_distributed_is_a_noop_for_one_process(monkeypatch):
    def joined(*args, **kwargs):
        raise AssertionError("a world was joined")

    monkeypatch.setattr(tdist.dist, "init_process_group", joined)
    tdist.initialize_distributed(num_processes=1, device="cpu")


def test_parallel_exports_match_jax():
    import pyspark_tf_gke_tpu.parallel as jpar
    import pyspark_tf_gke_tpu_torch.parallel as tpar

    assert tpar.__all__ == jpar.__all__
    assert tmesh.AXES == jmesh.AXES and tmesh.DATA_AXES == jmesh.DATA_AXES


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--num-processes", "2"]])
def test_serve_multi_host_flags_raise_naming_p11b(flags):
    from pyspark_tf_gke_tpu_torch.train import serve

    with pytest.raises(NotImplementedError, match="P11b"):
        serve.main(["--bundle", "unused", "--device", "cpu"] + flags)
