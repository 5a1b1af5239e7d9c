"""The training mesh (the port of the reference's ``repro.launch.mesh``).

A grid of ranks of the default process group, with axes ``("data",
"model")`` in one pod (:data:`AXES`) and ``("pod", "data", "model")``
over two (:data:`POD_AXES`): ``model`` is the context-parallel (CP)
axis, and a rank's CP group is its ``model`` row; ``pod`` and ``data``
carry the batch rows (``runtime.sharding.batch_axes_of``).  Parameters
are sharded over every axis (ZeRO-3, :mod:`repro_torch.runtime.zero`).
The grid's ``ranks`` are every rank in order by default, so rank r sits
at its row-major coordinate, ``(r // model, r % model)`` in one pod; an
explicit list lays a grid over a subset of the ranks (the survivors of
an elastic shrink, DESIGN.md §Recovery).  :func:`make_group_mesh`
re-tiles a ``data x model`` grid into CP groups of a smaller degree (the
adaptive dispatcher's tilings, DESIGN.md §Dispatch).
:func:`make_production_mesh` is the reference's production grid, 16 x 16
over a default group of 256 ranks (``train.py --mesh prod``), or with
``multi_pod`` 2 x 16 x 16 over 512 ranks; with one rank per GPU and the
ranks of a node numbered together, as ``torchrun`` numbers them, a
``model`` row of 16 spans two 8-GPU nodes.  A small grid of the pod
axes (2 x 1 x 2) is built through :func:`make_mesh` for the tests and
the chip smoke.

``dist.new_group`` is collective over the default group: every rank,
inside the grid or not, makes every group of every grid in the same
order.  So every rank calls these functions with the same arguments in
the same order, and a rank outside a grid gets None.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["AXES", "POD_AXES", "make_mesh", "make_local_mesh",
           "make_group_mesh", "make_production_mesh", "production_grid",
           "grid_coords", "PRODUCTION_SHAPE", "MULTI_POD_SHAPE",
           "mesh_axes", "mesh_coords", "mesh_world"]

#: the axes of one pod's grid, and of the two-pod grid
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
#: the reference's production mesh of one pod, and of two
PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)

# the group of every rank of a grid over a subset of the ranks, by the
# id of its mesh (the mesh is kept alive with it)
_WORLDS: dict[int, tuple[DeviceMesh, object]] = {}


def make_mesh(shape, axes, *, device_type: str,
              ranks=None) -> DeviceMesh | None:
    """The mesh of ``shape`` (one size per name of ``axes``) over
    ``ranks`` (default: the whole default process group, which must
    then hold ``prod(shape)`` ranks), row-major, on ``device_type``
    ("cuda" or "cpu"); None on a rank outside it.

    Its groups are made here with ``dist.new_group``, axis by axis from
    the last (``model``) to the first, the lines of each axis in
    row-major order of the other coordinates (then, for a subset of the
    ranks, the group of the whole grid), so every rank creates every
    group in the same order and in the backend of the default group
    (gloo where ranks share a card; ``init_device_mesh`` would pick a
    backend by device type).  Collectives over them go through
    :class:`repro_torch.core.comm.CPComm` with the backend the caller
    names."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    name = "x".join(map(str, shape))
    if math.prod(shape) != len(ranks):
        raise ValueError(f"a {name} mesh needs {math.prod(shape)} ranks, "
                         f"got {len(ranks)}")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                  for r in ranks):
        raise ValueError(f"mesh ranks {ranks} are not distinct ranks of "
                         f"a world of {world}")
    grid = torch.tensor(ranks).reshape(shape)
    me = dist.get_rank()
    mine = {}
    for i in reversed(range(len(axes))):
        for line in grid.movedim(i, -1).reshape(-1, shape[i]):
            members = line.tolist()
            group = dist.new_group(members)
            if me in members:
                mine[axes[i]] = group
    whole = dist.new_group(ranks) if len(ranks) < world else None
    if me not in ranks:
        return None
    mesh = DeviceMesh.from_group([mine[a] for a in axes], device_type,
                                 mesh=grid, mesh_dim_names=axes)
    if whole is not None:
        _WORLDS[id(mesh)] = (mesh, whole)
    return mesh


def make_local_mesh(data: int, model: int, *, device_type: str,
                    ranks=None) -> DeviceMesh | None:
    """The ``data x model`` mesh of ``ranks`` (:func:`make_mesh` over
    :data:`AXES`): the ``model`` rows' groups first, then the ``data``
    columns'."""
    return make_mesh((data, model), AXES, device_type=device_type,
                     ranks=ranks)


def make_group_mesh(data: int, model: int, cp_degree: int, *,
                    device_type: str, ranks=None) -> DeviceMesh | None:
    """The ``data x model`` grid re-tiled into CP groups of ``cp_degree``
    ranks: a ``(data * model / cp_degree) x cp_degree`` mesh of the same
    ranks, keeping the axis names, so the ZeRO-3 layout, the batch specs
    and the CP islands work unchanged (the group axis is its ``data``
    axis).  ``cp_degree`` divides ``model``, so a group is a contiguous
    slice of one CP row and never straddles two data rows."""
    if cp_degree < 1 or model % cp_degree:
        raise ValueError(f"cp_degree {cp_degree} does not divide model "
                         f"axis {model}")
    return make_local_mesh(data * model // cp_degree, cp_degree,
                           device_type=device_type, ranks=ranks)


def production_grid(multi_pod: bool = False) -> torch.Tensor:
    """The rank at each coordinate of the production mesh: the default
    group's ranks row-major over ``(data, model)``, or with
    ``multi_pod`` over ``(pod, data, model)``, the reference's device
    order."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    return torch.arange(math.prod(shape)).reshape(shape)


def grid_coords(grid: torch.Tensor, axes, rank: int) -> dict:
    """``{axis: index}`` of ``rank`` in ``grid`` (ranks by coordinate):
    what :func:`mesh_coords` returns on that rank of its mesh."""
    where = (grid == rank).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank} is not once in the grid")
    return dict(zip(axes, where[0].tolist()))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str) -> DeviceMesh:
    """The reference's production mesh over the default process group,
    which must hold exactly its ranks: ``data x model`` = 16 x 16 (256
    ranks, rank r at ``(r // 16, r % 16)``), or with ``multi_pod``
    ``pod x data x model`` = 2 x 16 x 16 (512 ranks, rank r at
    ``(r // 256, r // 16 % 16, r % 16)``)."""
    grid = production_grid(multi_pod)
    world = dist.get_world_size()
    if world != grid.numel():
        raise ValueError(
            f"the production mesh {'x'.join(map(str, grid.shape))} needs "
            f"a world of {grid.numel()} ranks, got {world}")
    return make_mesh(grid.shape, POD_AXES if multi_pod else AXES,
                     device_type=device_type,
                     ranks=grid.flatten().tolist())


def mesh_axes(mesh: DeviceMesh) -> dict:
    """``{axis: size}`` in axis order."""
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def mesh_coords(mesh: DeviceMesh) -> dict:
    """This rank's ``{axis: index}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def mesh_world(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``: None (the default
    group) for a mesh of the whole world."""
    entry = _WORLDS.get(id(mesh))
    return None if entry is None else entry[1]
