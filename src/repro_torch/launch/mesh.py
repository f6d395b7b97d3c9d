"""Production mesh construction: the port of the reference's
`repro.launch.mesh`, as `torch.distributed` `DeviceMesh`es with the
reference's axis names.

Defined as FUNCTIONS (never module-level constants) so importing this
module joins no process group. A `DeviceMesh` needs a group of its own
size: `make_production_mesh` needs 256 or 512 ranks in the default group
(`production_shape` gives the same axes without a group, which is all the
sharding rules read), and `make_host_mesh` takes the default group as it
is, or joins a world of one when none is initialised.
"""
from __future__ import annotations

import os
import tempfile
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.spec import MeshShape

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips), as
    the axis names and sizes the rules read."""
    if multi_pod:
        return MeshShape(MULTI_POD_AXES, (2, 16, 16))
    return MeshShape(PRODUCTION_AXES, (16, 16))


def _device_type(device) -> str:
    """The mesh's device type: "cuda" unless the caller asks for another
    (the CPU takes "cpu"); "cuda" must exist."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "build the mesh on the host")
    return dev.type


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """`production_shape`'s mesh over the ranks of the default group,
    which must hold exactly its 256 or 512 ranks."""
    shape = production_shape(multi_pod=multi_pod)
    n = 1
    for s in shape.sizes:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {shape.sizes} mesh needs {n} ranks in the "
                         f"default group; it has {world}")
    return init_device_mesh(_device_type(device), shape.sizes,
                            mesh_dim_names=shape.axis_names)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch-parallel axes of a production mesh (a `DeviceMesh` or a
    `MeshShape`)."""
    names = (mesh.mesh_dim_names if isinstance(mesh, DeviceMesh)
             else mesh.axis_names)
    return tuple(a for a in names if a in ("pod", "data"))


def make_host_mesh(device=None) -> DeviceMesh:
    """Every rank of the default group on one 'data' axis (tests,
    examples, one host). With no group initialised, this process joins a
    world of one first: a group on a `FileStore` in a new temporary
    directory (NCCL on the card, gloo on the CPU), no TCP rendezvous."""
    dtype = _device_type(device)
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="repro_torch_mesh_"), "store"), 1)
        dist.init_process_group("nccl" if dtype == "cuda" else "gloo",
                                store=store, rank=0, world_size=1)
    return init_device_mesh(dtype, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
