"""Parameter placement rules (counterpart of
``pyspark_tf_gke_tpu/parallel/sharding.py``).

A placement is written as the JAX package writes a ``PartitionSpec``:
a tuple with one entry per tensor dimension, the mesh axis that splits
it or ``None`` (trailing ``None`` entries may be left out). Two rules,
as in the JAX package:

1. **Shape-based FSDP** (:func:`fsdp_spec`) for the models without
   logical axes (MLP, CNN, ResNet): the largest dimension divisible by
   the ``fsdp`` extent is split, ties going to the later dimension; a
   leaf under ``min_size`` elements stays replicated.
2. **Logical axes** (:data:`LOGICAL_RULES`, :func:`logical_spec`) for
   the transformer models, whose modules declare each parameter's
   logical axes (``logical_axes`` on ``Dense``, ``TokenEmbed``, the
   norms, ``MoELayer`` and the ViT): ``embed`` goes to ``fsdp``;
   ``mlp``, ``heads`` and ``vocab`` go to ``tp``.

A split must divide the dimension. The JAX package leaves uneven splits
to XLA's padding; the port splits evenly or not at all: an uneven
``fsdp`` split, or an uneven ``vocab`` split over ``tp`` (GPT-2's 50257
rows), leaves that dimension whole, which moves no number (the data
axes gather a parameter before use, and a whole vocabulary is computed
alike on every ``tp`` rank). Any other uneven ``tp`` split raises: the
model's local heads and widths depend on it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
from torch import nn

from pyspark_tf_gke_tpu_torch.parallel.mesh import DATA_AXES, mesh_sizes

# Threshold in elements: 256KB of float32, the reference's
# MinSizePartitioner threshold.
DEFAULT_MIN_SIZE = (256 << 10) // 4

# Logical-name -> mesh-axis rules for the annotated (transformer) models.
LOGICAL_RULES = (
    ("batch", DATA_AXES),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("embed_out", None),
    ("heads", "tp"),
    ("head_dim", None),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("stage", "pp"),
    ("layers", None),
    ("norm", None),
)

Spec = Tuple


def mesh_extent_for(logical_axis: str, mesh, rules=LOGICAL_RULES) -> int:
    """Shards the rules give ``logical_axis`` on ``mesh`` (a
    ``DeviceMesh`` or ``{axis: size}``; 1 when unmapped or no mesh)."""
    if mesh is None:
        return 1
    target = dict(rules).get(logical_axis)
    if target is None:
        return 1
    axes = target if isinstance(target, (tuple, list)) else (target,)
    sizes = mesh_sizes(mesh)
    out = 1
    for a in axes:
        if a is not None:
            out *= sizes.get(a, 1)
    return out


def fsdp_spec(shape: tuple, mesh, min_size: int = DEFAULT_MIN_SIZE) -> Spec:
    """The spec splitting the largest fsdp-divisible dimension of
    ``shape``; ``()`` (replicated) under ``min_size`` elements or when no
    dimension divides."""
    fsdp = mesh_sizes(mesh).get("fsdp", 1)
    if fsdp <= 1 or int(np.prod(shape)) < min_size:
        return ()
    best = -1
    best_dim = -1
    for i, d in enumerate(shape):
        if d % fsdp == 0 and d >= best:
            best, best_dim = d, i
    if best_dim < 0:
        return ()
    spec = [None] * len(shape)
    spec[best_dim] = "fsdp"
    return tuple(spec)


def fsdp_shardings(params: Mapping, mesh,
                   min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Spec]:
    """``{name: spec}`` for an un-annotated parameter tree."""
    return {k: fsdp_spec(tuple(v.shape), mesh, min_size)
            for k, v in params.items()}


def logical_spec(axes: Optional[tuple], shape: tuple, mesh,
                 rules=LOGICAL_RULES, fit: bool = False) -> Spec:
    """The spec of a leaf with logical ``axes`` (flax's
    ``logical_to_mesh_axes``: each name takes its first rule whose mesh
    axis the leaf does not use yet), evened out as the module docstring
    says. ``axes=None`` (an unannotated leaf of an annotated model)
    is replicated. ``fit=True`` leaves ANY dimension whole that its
    extent does not divide (the serving placement's ``fit_spec``)."""
    if axes is None:
        return ()
    sizes = mesh_sizes(mesh)
    used = set()
    spec = []
    for name, dim in zip(axes, shape):
        target = None
        for rule_name, mesh_axis in rules:
            if rule_name != name:
                continue
            names = (mesh_axis if isinstance(mesh_axis, (tuple, list))
                     else (mesh_axis,))
            if mesh_axis is None or not used & set(names):
                target = mesh_axis
                break
        if target is not None:
            names = target if isinstance(target, (tuple, list)) else (target,)
            used.update(names)
            extent = int(np.prod([sizes.get(a, 1) for a in names]))
            if dim % extent:
                if "tp" in names and name != "vocab" and not fit:
                    raise ValueError(
                        f"logical axis {name!r} of size {dim} does not "
                        f"split over {target}={extent}")
                target = None
        spec.append(target)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def logical_axes(model: nn.Module) -> Dict[str, Optional[tuple]]:
    """``{flax path: logical axes or None}`` of every trainable
    parameter, from the ``logical_axes`` the model's modules declare."""
    out = {}
    for mod_name, module in model.named_modules():
        declared = getattr(module, "logical_axes", None) or {}
        for p_name, p in module.named_parameters(recurse=False):
            if p.requires_grad:
                path = f"{mod_name}.{p_name}" if mod_name else p_name
                out[path.replace(".", "/")] = declared.get(p_name)
    return out


def logical_shardings(model: nn.Module, mesh,
                      rules=LOGICAL_RULES) -> Dict[str, Spec]:
    """``{flax path: spec}`` of an annotated model's parameters."""
    shapes = {name.replace(".", "/"): tuple(p.shape)
              for name, p in model.named_parameters()}
    return {path: logical_spec(axes, shapes[path], mesh, rules)
            for path, axes in logical_axes(model).items()}


def model_shardings(model: nn.Module, mesh, min_size: int = DEFAULT_MIN_SIZE,
                    rules=LOGICAL_RULES) -> Dict[str, Spec]:
    """The JAX trainer's choice (``init_state``): the logical rules when
    any parameter carries logical axes, else :func:`fsdp_spec` on every
    parameter."""
    axes = logical_axes(model)
    if any(a is not None for a in axes.values()):
        return logical_shardings(model, mesh, rules)
    shapes = {name.replace(".", "/"): tuple(p.shape)
              for name, p in model.named_parameters() if p.requires_grad}
    return {k: fsdp_spec(s, mesh, min_size) for k, s in shapes.items()}


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the
    mesh dimension that splits tensor dimension ``d``, ``Replicate``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out
