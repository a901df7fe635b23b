"""The training mesh on ``torch.distributed`` (counterpart of
``pyspark_tf_gke_tpu/parallel``): ``mesh`` (the rank layout and the
``DeviceMesh``), ``sharding`` (where each parameter lives),
``distributed`` (joining the world) and ``spmd`` (one rank's groups,
its differentiable collectives and the placement of a model).

The JAX package's ``parallel/compat.py`` has no counterpart: it only
spells ``shard_map`` and flax's unboxing across jax versions. Its
``parallel/pipeline.py`` (the GPipe schedule) is not ported yet
(ROADMAP, P11b).
"""

from pyspark_tf_gke_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXES,
    make_mesh,
    make_hybrid_mesh,
    mesh_from_spec,
    batch_sharding,
    replicated_sharding,
    local_mesh_for_testing,
)
from pyspark_tf_gke_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
    fsdp_spec,
    fsdp_shardings,
    logical_shardings,
)
from pyspark_tf_gke_tpu_torch.parallel.distributed import (
    build_coordinator_address,
    initialize_distributed,
    process_ordinal_from_hostname,
    validate_ipv4,
)

__all__ = [
    "AXES",
    "DATA_AXES",
    "make_mesh",
    "make_hybrid_mesh",
    "mesh_from_spec",
    "batch_sharding",
    "replicated_sharding",
    "local_mesh_for_testing",
    "LOGICAL_RULES",
    "fsdp_spec",
    "fsdp_shardings",
    "logical_shardings",
    "build_coordinator_address",
    "initialize_distributed",
    "process_ordinal_from_hostname",
    "validate_ipv4",
]
