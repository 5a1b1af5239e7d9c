"""The training mesh (the port of the reference's ``repro.launch.mesh``).

A ``data x model`` grid of the ranks of the default process group, with
axes ``("data", "model")``: ``model`` is the context-parallel (CP) axis,
and a rank's CP group is its ``model`` row; ``data`` carries the batch
rows.  Parameters are sharded over both (ZeRO-3,
:mod:`repro_torch.runtime.zero`).  Rank r sits at ``(r // model,
r % model)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["AXES", "make_local_mesh", "mesh_axes", "mesh_coords"]

AXES = ("data", "model")


def make_local_mesh(data: int, model: int, *, device_type: str) -> DeviceMesh:
    """The ``data x model`` mesh of the default process group (which
    must hold ``data * model`` ranks), on ``device_type`` ("cuda" or
    "cpu").

    Its groups are made here with ``dist.new_group``, the ``model`` rows
    first and then the ``data`` columns, each in index order, so every
    rank creates every group in the same order and in the backend of the
    default group (gloo where ranks share a card; ``init_device_mesh``
    would pick a backend by device type).  Collectives over them go
    through :class:`repro_torch.core.comm.CPComm` with the backend the
    caller names."""
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} ranks, "
                         f"the process group has {world}")
    grid = torch.arange(world).reshape(data, model)
    me = dist.get_rank()
    mine = {}
    for axis, lines in (("model", grid), ("data", grid.T)):
        for line in lines:
            ranks = line.tolist()
            group = dist.new_group(ranks)
            if me in ranks:
                mine[axis] = group
    return DeviceMesh.from_group([mine[a] for a in AXES], device_type,
                                 mesh=grid, mesh_dim_names=AXES)


def mesh_axes(mesh: DeviceMesh) -> dict:
    """``{axis: size}`` in axis order."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def mesh_coords(mesh: DeviceMesh) -> dict:
    """This rank's ``{axis: index}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
