"""One rank's view of a training mesh: the process groups, the
differentiable collectives the models call, and the placement of a
model's parameters. The JAX package has no counterpart: there ``jit``
over a ``Mesh`` partitions one global program and XLA inserts the
collectives; here every rank runs its own program and calls them.

**Data axes.** Every rank that shares the ``tp`` coordinate is in the
*data group* (``dp`` x ``fsdp`` x ``sp``; ``pp`` and ``ep`` are 1 in
this slice). Losses and metrics are reduced over it with
:func:`all_reduce_sum`, whose backward is again an all-reduce (the
adjoint of a sum over ranks), so every rank ends with the global value
and the gradients summed over the group are ``W`` times the gradient of
the global loss, ``W`` the group's size; :meth:`Spmd.reduce_grads`
divides by ``W``, as FSDP does by default.

**Tensor axis.** The ``tp`` ranks of one data coordinate see the same
rows and compute identical activations outside the tensor-parallel
regions. A column-parallel layer (kernel split on its output) reads
:func:`copy_to_tp` of its input, whose backward all-reduces the partial
input gradients; a row-parallel layer (kernel split on its input) ends
in :func:`reduce_from_tp`, which all-reduces the partial outputs and
passes the gradient through; :func:`gather_from_tp` joins a split
output (its backward keeps the rank's slice). These are Megatron's
``f``, ``g`` and gather, over the port's flax-layout ``Dense``.

**Parameters.** :meth:`Spmd.place` gives each parameter its placement
(``parallel/sharding.py``) and keeps a *master* shard of it: split on
every axis of its spec. The module itself holds the parameter whole on
the data axes and split on ``tp`` (what its forward computes with): a
leaf not split on ``fsdp`` IS its master, and an ``fsdp``-split one is
gathered into the module before each forward by one ``all_gather`` over
the ``fsdp`` group (:meth:`Spmd.gather`). The optimizer steps the
masters (``train/harness.py``), and the checkpoint gathers them to the
full tensors a one-device run saves through the DTensor of each
placement (:meth:`Spmd.full`). No DTensor reaches a model: the kernels'
wrappers see each rank's plain local tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pyspark_tf_gke_tpu_torch.parallel.mesh import (AXES, DATA_AXES,
                                                    batch_sharding,
                                                    mesh_sizes)
from pyspark_tf_gke_tpu_torch.parallel.sharding import placements

# the axes a parameter is gathered over before use; tp stays split
GATHERED = ("fsdp",)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; differentiable
    (the backward all-reduces the cotangents). ``group=None`` is the
    identity."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_cat(x: torch.Tensor, dim: int, group, order) -> torch.Tensor:
    """The ranks' ``x`` joined on ``dim`` in mesh-coordinate order:
    ``order[c]`` is the group rank at coordinate ``c`` (a hybrid mesh's
    axis need not list its ranks in the group's order)."""
    parts = [torch.empty_like(x) for _ in order]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([parts[i] for i in order], dim=dim)


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return all_gather_cat(x, dim, tp.group, tp.order)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return g.chunk(tp.size, dim=ctx.dim)[tp.rank].contiguous(), None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The ``tp`` group a model's tensor-parallel layers run over:
    ``rank`` is this rank's ``tp`` coordinate, ``order[c]`` the group
    rank at coordinate ``c``."""

    group: object
    size: int
    rank: int
    order: Tuple[int, ...]

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the backward sums the input gradients."""
        return _CopyToTP.apply(x, self.group)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial outputs; gradient passed on."""
        return _ReduceFromTP.apply(x, self.group)

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' slices joined on ``dim``; the backward keeps this
        rank's slice."""
        return _GatherFromTP.apply(x, dim, self)


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where a master shard sits in its whole leaf: the whole ``shape``,
    per dimension the group that splits it (``None``: whole), and how
    many ranks hold the same shard."""

    shape: Tuple[int, ...]
    groups: Tuple[object, ...]
    replicas: int

    def drop(self, dim: int) -> "LeafLayout":
        """The layout of a reduction over ``dim`` (Adafactor's factored
        moments)."""
        return LeafLayout(self.shape[:dim] + self.shape[dim + 1:],
                          self.groups[:dim] + self.groups[dim + 1:],
                          self.replicas)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _spec_dims(spec, ndim: int) -> list:
    return [_entry_axes(spec[d] if d < len(spec) else None)
            for d in range(ndim)]


def _group_ranks(array: np.ndarray, axes: Sequence[str]) -> list:
    """The rank lists of the groups that vary over ``axes`` only."""
    keep = [i for i, a in enumerate(AXES) if a in axes]
    moved = np.moveaxis(array, keep, list(range(len(keep))))
    flat = moved.reshape(int(np.prod(moved.shape[:len(keep)])), -1)
    return [sorted(int(r) for r in flat[:, j]) for j in range(flat.shape[1])]


class Spmd:
    """This rank's groups on ``mesh`` (a ``DeviceMesh`` with the
    canonical axis names) and the placement of a model on it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        array = mesh.mesh.numpy()
        coord = np.argwhere(array == dist.get_rank())[0]
        self.coord = dict(zip(AXES, (int(c) for c in coord)))
        data_axes = tuple(a for a in AXES if a != "tp")
        self.data_size = int(np.prod([self.sizes[a] for a in data_axes]))
        # every rank makes every group, in the same order
        self.data_group = self._subgroup(_group_ranks(array, data_axes))
        # the ranks that split a batch's rows (dp x fsdp), and this
        # rank's block among them
        self.batch_group = self._subgroup(_group_ranks(array, DATA_AXES))
        self.batch_count = self.sizes["dp"] * self.sizes["fsdp"]
        self.batch_index = (self.coord["dp"] * self.sizes["fsdp"]
                            + self.coord["fsdp"])
        self._array = array
        self._orders = {a: self._axis_order(a) for a in AXES
                        if self.sizes[a] > 1}
        self.tp = (TensorParallel(mesh.get_group("tp"), self.sizes["tp"],
                                  self.coord["tp"], self._orders["tp"])
                   if self.sizes["tp"] > 1 else None)
        self.sp_group = (mesh.get_group("sp") if self.sizes["sp"] > 1
                         else None)
        self.specs: Dict[str, tuple] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self._module_params: Dict[str, nn.Parameter] = {}

    def _subgroup(self, groups: list):
        if len(groups[0]) == 1:
            return None
        if len(groups) == 1:
            return dist.group.WORLD
        mine, _ = dist.new_subgroups_by_enumeration(groups)
        return mine

    def axis_group(self, axis: str):
        return self.mesh.get_group(axis)

    def _axis_order(self, axis: str) -> Tuple[int, ...]:
        """``order[c]``: the rank of ``axis``'s group (this rank's) at
        coordinate ``c``."""
        members = dist.get_process_group_ranks(self.axis_group(axis))
        index = [slice(None) if a == axis else self.coord[a] for a in AXES]
        along = [int(r) for r in self._array[tuple(index)]]
        return tuple(members.index(r) for r in along)

    # -- reductions over the data group -----------------------------------

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group (differentiable)."""
        return all_reduce_sum(x.float() if not x.is_floating_point() else x,
                              self.data_group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the ranks' ``x`` over the data group: the global
        mean of a per-rank mean over equal row counts."""
        return self.sum(x) / self.data_size

    # -- batches -------------------------------------------------------------

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (``batch_sharding``) and,
        under ``sp > 1``, its block of every ``[B, S]`` array's sequence
        (the logical ``seq`` axis on ``sp``)."""
        rows = len(next(iter(batch.values())))
        sel = batch_sharding(self.mesh, rows)
        out = {k: v[sel] for k, v in batch.items()}
        sp = self.sizes["sp"]
        if sp > 1:  # the block the sp group's ring places at this rank
            block = dist.get_rank(self.sp_group)
            out = {k: (np.array_split(v, sp, axis=1)[block]
                       if v.ndim == 2 else v) for k, v in out.items()}
        return out

    # -- parameters ----------------------------------------------------------

    def _slice(self, t: torch.Tensor, spec, axes=None) -> torch.Tensor:
        """The block of ``t`` this rank holds on the axes of ``spec``
        (restricted to ``axes`` when given)."""
        for d, names in enumerate(_spec_dims(spec, t.dim())):
            for a in names:
                if axes is None or a in axes:
                    t = t.chunk(self.sizes[a], dim=d)[self.coord[a]]
        return t

    def layout(self, name: str) -> LeafLayout:
        spec, shape = self.specs[name], self.shapes[name]
        groups, shards = [], 1
        for names in _spec_dims(spec, len(shape)):
            split = [a for a in names if self.sizes[a] > 1]
            if len(split) > 1:
                raise ValueError(f"{name}: one dimension over {split}")
            groups.append(self.axis_group(split[0]) if split else None)
            shards *= int(np.prod([self.sizes[a] for a in split]))
        return LeafLayout(shape, tuple(groups),
                          dist.get_world_size() // shards)

    def place(self, model: nn.Module, specs: Dict[str, tuple]
              ) -> Dict[str, torch.Tensor]:
        """Give ``model`` its ``tp`` slices and its groups (``spmd``, and
        ``sp_group`` under ``sp > 1``), and return ``{parameter name:
        master shard}`` of its trainable parameters (``specs`` is keyed
        by flax path)."""
        for module in model.modules():
            if hasattr(module, "spmd"):
                module.spmd = self
            if self.sp_group is not None and hasattr(module, "sp_group"):
                module.sp_group = self.sp_group
        masters = {}
        for name, p in list(model.named_parameters()):
            if not p.requires_grad:
                continue
            path = name
            spec = specs[name.replace(".", "/")]
            self.specs[path], self.shapes[path] = spec, tuple(p.shape)
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            local = self._slice(p.detach(), spec, ("tp",))
            param = p
            if local.shape != p.shape:
                param = nn.Parameter(local.clone())
                setattr(owner, leaf, param)
            self._module_params[path] = param
            if self._gathered(path):
                with torch.no_grad():
                    masters[path] = self._slice(local, spec,
                                                GATHERED).clone()
            else:
                masters[path] = param
        return masters

    def _gathered(self, path: str) -> bool:
        return any(self.sizes[a] > 1 for names in _spec_dims(
            self.specs[path], len(self.shapes[path])) for a in names
            if a in GATHERED)

    def _dtensor(self, local: torch.Tensor, path: str, layout_spec=None,
                 shape=None):
        from torch.distributed.tensor import DTensor

        spec = self.specs[path] if layout_spec is None else layout_spec
        shape = self.shapes[path] if shape is None else shape
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return DTensor.from_local(local, self.mesh, placements(spec, self.mesh),
                                  shape=torch.Size(shape), stride=stride)

    @torch.no_grad()
    def gather(self, masters: Dict[str, torch.Tensor],
               into: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """The module-side tensors (whole on the data axes, split on
        ``tp``) of ``masters``: written into the model's parameters
        (``into=None``) or returned as new tensors."""
        out = {}
        for path, master in masters.items():
            target = self._module_params[path]
            if not self._gathered(path):
                if into is None:
                    continue
                out[path] = master
                continue
            full = master
            for d, names in enumerate(_spec_dims(self.specs[path],
                                                 master.dim())):
                for a in names:
                    if a in GATHERED and self.sizes[a] > 1:
                        full = all_gather_cat(full, d, self.axis_group(a),
                                              self._orders[a])
            if into is None:
                target.copy_(full)
            else:
                out[path] = full
        return out

    @torch.no_grad()
    def reduce_grads(self) -> Dict[str, torch.Tensor]:
        """The masters' gradients: the model's gradients summed over the
        data group in one flat all-reduce (none in a group of one),
        divided by its size, and cut to each master's shard."""
        paths = list(self._module_params)
        grads = []
        for path in paths:
            p = self._module_params[path]
            grads.append(p.grad if p.grad is not None
                         else torch.zeros_like(p))
            p.grad = None
        if self.data_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.data_group)
            flat.div_(self.data_size)
            grads = [part.view_as(g) for part, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        return {path: (self._slice(g, self.specs[path], GATHERED)
                       if self._gathered(path) else g)
                for path, g in zip(paths, grads)}

    # -- whole tensors (checkpoints) -----------------------------------------

    def full(self, local: torch.Tensor, path: str, drop: Optional[int] = None
             ) -> torch.Tensor:
        """The whole leaf of the master-shaped ``local`` (a collective:
        every rank calls it). ``drop`` names a dimension of the leaf
        that ``local`` was reduced over (Adafactor's ``v_row``/``v_col``)."""
        spec, shape = self._dropped(path, drop)
        if not any(self.sizes[a] > 1 for names in _spec_dims(spec, len(shape))
                   for a in names):
            return local
        return self._dtensor(local, path, spec, shape).full_tensor()

    def shard(self, full: torch.Tensor, path: str,
              drop: Optional[int] = None) -> torch.Tensor:
        """This rank's master-shaped block of the whole leaf ``full``."""
        spec, _ = self._dropped(path, drop)
        return self._slice(full, spec)

    def _dropped(self, path: str, drop: Optional[int]):
        spec, shape = self.specs[path], self.shapes[path]
        if drop is None:
            return spec, shape
        dims = _spec_dims(spec, len(shape))
        del dims[drop]
        return (tuple(d[0] if d else None for d in dims),
                shape[:drop] + shape[drop + 1:])

