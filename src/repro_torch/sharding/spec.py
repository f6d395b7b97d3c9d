"""The port's spec form and its DTensor placements.

A spec mirrors jax's `PartitionSpec`: a tuple with one entry per tensor
dimension, each an axis name of the mesh, a tuple of axis names (the
dimension split over their product, the first the major one), or None
(not split). `P(*entries)` builds one as `PartitionSpec(*entries)` does.

The rules (`sharding.lm`, `.recsys`, `.gnn`) read only the size of each
named axis, as the reference's read `mesh.shape[axis]`: they take a
`DeviceMesh` or a `MeshShape` stand-in (axis names and sizes, no group),
so the production shapes, 256 or 512 ranks, can be asked of them in a
process that has none. `placements` and `distribute` need a real
`DeviceMesh`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def P(*entries: Entry) -> Spec:
    """A spec: one entry a dimension (see the module's docstring)."""
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes without its ranks: what the rules
    read. `shape` maps each axis name to its size, in mesh order, as jax's
    `Mesh.shape` does."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a `MeshShape`, in mesh
    order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axes_of(entry: Entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def size_of(mesh, axes) -> int:
    """The product of the sizes of `axes` (a name or a tuple of names)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes_of(axes):
        n *= sizes[a]
    return n


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The DTensor placements, one a mesh dimension, of a tensor laid out
    by `spec` on `mesh`: `Shard(d)` on each axis that entry d names,
    `Replicate()` on the others. A multi-axis entry shards its dimension
    major to minor as jax does, which DTensor's placements express only
    when the entry names its axes in mesh order: another order raises, as
    does an axis named twice or not in the mesh. An axis of size 1 splits
    nothing, so it takes `Replicate()`, the same layout: DTensor's view
    rules refuse to merge a dim of size 1 split over an axis (a batch of
    one over a "data" axis of one)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not in the "
                                 f"mesh's {names}")
            if a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} named twice")
            seen.add(a)
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: entry {entry} must name its axes "
                             f"in the mesh's order {names}")
    return tuple(out)


def distribute(t: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> DTensor:
    """`t` (the whole tensor, on every rank alike, or on meta) as a
    DTensor laid out by `spec`: each rank keeps its slice."""
    return distribute_tensor(t, mesh, placements(spec, mesh))


def shard_parameters(module: nn.Module, mesh: DeviceMesh,
                     specs: Mapping[str, Spec]) -> nn.Module:
    """Each parameter of `module` replaced, in place, by a DTensor
    parameter laid out on `mesh` by `specs[name]` (every rank must hold
    the same whole weights beforehand; meta weights stay meta). Returns
    the module."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), mesh,
                                                   specs[name]),
                                        requires_grad=p.requires_grad))
    return module


def spec_of(t: torch.Tensor) -> Optional[Spec]:
    """The spec of a DTensor that `placements` would give (None for a
    plain tensor); a partial placement raises."""
    if not isinstance(t, DTensor):
        return None
    names = t.device_mesh.mesh_dim_names
    dims: list = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in dims)
