"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Single pod: (16, 16) over ("data", "model") = 256 cards.
Multi-pod:  (2, 16, 16) over ("pod", "data", "model") = 512 cards.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, built over the default process group, which the caller
joins first (``init_process_group``): NCCL or gloo for real ranks, or
the in-process ``fake`` group of ``launch.dryrun``, which holds any
number of ranks and moves no data.  Importing this module joins nothing.

``data_axes``, ``mesh_axis_size`` and the helpers below also take any
object with ``axis_names`` and a ``shape`` mapping of axis name to size
(the reference tests' ``FakeMesh``), so the sharding rules run on shapes
alone.
"""

from __future__ import annotations

import math
from typing import Sequence


def axis_names(mesh) -> tuple:
    """The mesh's axis names, major to minor."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}, major to minor."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the default process group (rank r at index r,
    row-major).  Raises RuntimeError when no group is joined or it has
    fewer ranks than the mesh needs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {tuple(shape)} needs an initialized "
                           f"process group (init_process_group first)")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    """Mesh axes carrying the batch (pod is an outer data axis)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_axis_size(mesh, names) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in names)
