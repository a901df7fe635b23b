"""The device mesh (counterpart of ``pyspark_tf_gke_tpu/parallel/mesh.py``).

The JAX package lays its chips out as a ``jax.sharding.Mesh`` with named
axes; the port lays its ranks out as a ``torch.distributed``
``DeviceMesh`` with the same names (``mesh_dim_names=AXES``), one rank a
card. Each constructor is split in two: a pure function that gives the rank
array in the canonical axis order (:func:`mesh_array`,
:func:`hybrid_mesh_array`), which needs no process group and mirrors the
JAX constructor's ``Mesh.devices`` id for id, and the wrapper that makes the
``DeviceMesh`` over it (:func:`make_mesh`, :func:`make_hybrid_mesh`,
:func:`mesh_from_spec`).

Axes (any may be 1): ``dp`` data parallelism (parameters replicated),
``fsdp`` data parallelism that shards the parameters and the optimizer
state, ``pp`` pipeline stages, ``tp`` tensor parallelism within a layer,
``sp`` sequence parallelism, ``ep`` expert parallelism. A global batch
is split over :data:`DATA_AXES`; :func:`batch_sharding` gives the block of
rows a rank holds: the block the JAX device at the same mesh coordinates
holds under the JAX ``batch_sharding``.

On GPUs a "slice" of the hybrid mesh is a node: the DCN component of an
axis is the node and the ICI component the node's cards. Ranks are
grouped by node when the number of nodes equals the number of slices,
and in contiguous runs otherwise, as the JAX constructor falls back from
``slice_index`` to process groups and then to contiguous chunks.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")

# Axes a global batch is split over: fsdp is data parallelism that also
# shards the parameters, so the batch spans both.
DATA_AXES = ("dp", "fsdp")


def mesh_array(axes: Optional[Mapping[str, int]], ranks: Sequence[int]
               ) -> np.ndarray:
    """``ranks`` reshaped to the canonical axis order, as ``make_mesh``
    reshapes its devices: missing axes are 1, an empty ``axes`` puts
    every rank on ``dp``, and one axis may be -1 ("take the rest")."""
    n = len(ranks)
    sizes = {a: 1 for a in AXES}
    if axes:
        for name, size in axes.items():
            if name not in sizes:
                raise ValueError(f"Unknown mesh axis {name!r}; valid axes: {AXES}")
            sizes[name] = int(size)
    else:
        sizes["dp"] = n

    wildcard = [a for a, s in sizes.items() if s == -1]
    if len(wildcard) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if wildcard:
        fixed = int(np.prod([s for s in sizes.values() if s != -1]))
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[wildcard[0]] = n // fixed

    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(f"Mesh axes {dict(sizes)} require {total} devices, have {n}")
    return np.asarray(ranks).reshape(tuple(sizes[a] for a in AXES))


def hybrid_mesh_array(dcn_axes: Optional[Mapping[str, int]],
                      ici_axes: Optional[Mapping[str, int]],
                      ranks: Sequence[int],
                      nodes: Optional[Sequence] = None,
                      force_contiguous: bool = False) -> np.ndarray:
    """The slice-major rank array of ``make_hybrid_mesh``: for each axis
    the DCN component varies slowest, so an axis-local group of
    ``ici_axes[a]`` ranks lies on one node. ``nodes[i]`` names the node
    of ``ranks[i]``; ranks are grouped by node when there are as many
    nodes as slices (and not ``force_contiguous``), else in contiguous
    runs."""
    ranks = list(ranks)
    n = len(ranks)
    dcn = {a: 1 for a in AXES}
    ici = {a: 1 for a in AXES}
    for name, size in (dcn_axes or {}).items():
        if name not in dcn:
            raise ValueError(f"Unknown mesh axis {name!r}; valid axes: {AXES}")
        dcn[name] = int(size)
    if ici_axes:
        for name, size in ici_axes.items():
            if name not in ici:
                raise ValueError(
                    f"Unknown mesh axis {name!r}; valid axes: {AXES}")
            ici[name] = int(size)
    else:
        ici["dp"] = -1  # make_mesh's default: remaining ranks on dp

    wildcard = [(spec, a) for spec in (dcn, ici)
                for a, s in spec.items() if s == -1]
    if len(wildcard) > 1:
        raise ValueError("At most one hybrid-mesh axis may be -1")
    if wildcard:
        spec, axis = wildcard[0]
        spec[axis] = 1
        fixed = int(np.prod(list(dcn.values()))) * int(
            np.prod(list(ici.values())))
        if n % fixed:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {fixed}")
        spec[axis] = n // fixed
    n_slices = int(np.prod(list(dcn.values())))
    per_slice = int(np.prod(list(ici.values())))
    if n_slices * per_slice != n:
        raise ValueError(
            f"dcn {dict((a, s) for a, s in dcn.items() if s > 1)} x ici "
            f"{dict((a, s) for a, s in ici.items() if s > 1)} require "
            f"{n_slices}x{per_slice}={n_slices * per_slice} devices, have {n}")

    by_node = (not force_contiguous and nodes is not None and n_slices > 1
               and len(set(nodes)) == n_slices)
    if by_node:
        logging.getLogger(__name__).info(
            "make_hybrid_mesh: treating the %d nodes as the DCN slices",
            n_slices)
        groups: dict = {}
        for r, node in zip(ranks, nodes):
            groups.setdefault(node, []).append(r)
        grouped = [groups[k] for k in sorted(groups)]
    else:
        grouped = [ranks[i:i + per_slice] for i in range(0, n, per_slice)]
    if len(grouped) != n_slices or any(len(g) != per_slice for g in grouped):
        raise ValueError(
            f"Device slice grouping gave {[len(g) for g in grouped]} devices "
            f"per slice; need {n_slices} slices x {per_slice}")

    dcn_shape = tuple(dcn[a] for a in AXES)
    ici_shape = tuple(ici[a] for a in AXES)
    arr = np.empty(tuple(d * i for d, i in zip(dcn_shape, ici_shape)),
                   dtype=np.int64)
    for ordinal, group in enumerate(grouped):
        dcn_idx = np.unravel_index(ordinal, dcn_shape)
        dest = tuple(slice(di * isz, (di + 1) * isz)
                     for di, isz in zip(dcn_idx, ici_shape))
        arr[dest] = np.asarray(group).reshape(ici_shape)
    return arr


def _device_type(device) -> str:
    return torch.device(device).type


def _node_names() -> list:
    """Each rank's host name, gathered over the world."""
    import socket

    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names


def _device_mesh(array: np.ndarray, device):
    from torch.distributed.device_mesh import DeviceMesh

    from pyspark_tf_gke_tpu_torch.parallel.distributed import ensure_world

    ensure_world(device)
    return DeviceMesh(_device_type(device), torch.as_tensor(array),
                      mesh_dim_names=AXES)


def _world_ranks(device) -> list:
    import torch.distributed as dist

    from pyspark_tf_gke_tpu_torch.parallel.distributed import ensure_world

    ensure_world(device)
    return list(range(dist.get_world_size()))


def make_mesh(axes: Optional[Mapping[str, int]] = None,
              device="cuda"):
    """A ``DeviceMesh`` over every rank of the world (a world of one
    rank is made when none exists), axes in the canonical order;
    ``device`` is ``cuda`` (NCCL) or ``cpu`` (gloo)."""
    return _device_mesh(mesh_array(axes, _world_ranks(device)), device)


def make_hybrid_mesh(dcn_axes: Optional[Mapping[str, int]] = None,
                     ici_axes: Optional[Mapping[str, int]] = None,
                     device="cuda", force_contiguous: bool = False):
    """A ``DeviceMesh`` whose rank order keeps each axis's ICI groups on
    one node (:func:`hybrid_mesh_array`)."""
    ranks = _world_ranks(device)
    nodes = None if force_contiguous else _node_names()
    return _device_mesh(hybrid_mesh_array(dcn_axes, ici_axes, ranks, nodes,
                                          force_contiguous), device)


def mesh_from_spec(ici_axes: Optional[Mapping[str, int]] = None,
                   dcn_axes: Optional[Mapping[str, int]] = None,
                   device="cuda"):
    """A non-empty ``dcn_axes`` selects the hybrid constructor, otherwise
    the ordinary one."""
    if dcn_axes:
        return make_hybrid_mesh(dcn_axes, ici_axes, device)
    return make_mesh(ici_axes or None, device)


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def batch_block(array: np.ndarray, rank: int, rows: int) -> slice:
    """The rows of a ``rows``-row global batch that ``rank`` holds in the
    rank ``array``: the block ``dp * fsdp_size + fsdp`` of ``dp *
    fsdp_size`` equal blocks, as the JAX ``batch_sharding``'s ``P(DATA_AXES)``
    splits the leading dimension."""
    coord = dict(zip(AXES, (int(c[0]) for c in np.nonzero(array == rank))))
    sizes = dict(zip(AXES, array.shape))
    count = sizes["dp"] * sizes["fsdp"]
    if rows % count:
        raise ValueError(f"global batch {rows} not divisible by the "
                         f"{count} data shards")
    index = coord["dp"] * sizes["fsdp"] + coord["fsdp"]
    block = rows // count
    return slice(index * block, (index + 1) * block)


def batch_sharding(mesh, rows: int) -> slice:
    """This rank's rows of a ``rows``-row global batch on ``mesh``
    (the JAX ``batch_sharding`` places a batch; here each rank takes
    its rows)."""
    import torch.distributed as dist

    return batch_block(mesh.mesh.numpy(), dist.get_rank(), rows)


def replicated_sharding(mesh) -> list:
    """DTensor placements of a leaf replicated on every axis (the
    JAX ``replicated_sharding``'s ``P()``)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def local_mesh_for_testing(n: int = 8,
                           axes: Optional[Mapping[str, int]] = None):
    """A CPU (gloo) mesh over a world of ``n`` ranks, the tests' stand-in
    for a multi-card machine."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"local_mesh_for_testing({n}) needs an "
                           f"initialised world of {n} ranks")
    return make_mesh(axes or {"dp": n}, "cpu")
