"""ZeRO-3 over a mesh of any of the axes ``pod``, ``data`` and ``model``
(``launch.mesh``): each rank holds only its shard of
every parameter leaf, and of the optimizer's fp32 master, ``mu`` and
``nu`` (the layout of :mod:`repro_torch.runtime.sharding`; the
reference shards the same way and lets XLA insert the collectives).

* **Gathering.**  A leaf is gathered where it is used, one mesh axis at
  a time (the inner axis of a stacked entry first), with
  :func:`~repro_torch.core.comm.all_gather_tiled`, whose backward is a
  reduce-scatter.  The transformer gathers a layer inside its
  rematerialized function (``gather`` hook of ``models.transformer``),
  so the backward gathers it again and at most one layer is whole at a
  time.  A layer's MoE expert leaves are gathered over every axis but
  ``model``: the expert-parallel island computes with this rank's
  experts (the reference's ``shard_map`` in-spec).
* **Gradients.**  Through the gathers, a shard's gradient arrives summed
  over the axes the leaf is split over; :meth:`Zero3.reduce_grads_` sums
  it over the axes it is whole on.  Each shard then holds the sum over
  all ranks: the gradient of the global masked-CE mean, since each rank's
  loss is its CE sum over the world's token count.  An expert leaf is
  split over ``model``, so its gradient is never summed over ``model``:
  each rank's experts are its own, and the island's all-to-all brought
  every rank's tokens to them.
* **Norms and statistics** count each leaf once: a rank adds a leaf's
  squares only where its coordinate on every axis the leaf is whole on
  is 0.

:meth:`Zero3.from_layout` builds one rank's layout from its axes,
coordinates and leaf shapes with the communicators a factory gives (the
dry run's recording comm, ``core.comm.RecordingComm``), so one rank's
step runs without a process group.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.comm import CPComm, all_gather_tiled, all_reduce_
from repro_torch.launch.mesh import mesh_axes, mesh_coords, mesh_world
from repro_torch.optim.clipping import sum_of_squares
from .sharding import (is_expert_leaf, param_specs, replicated_axes,
                       shard_shape, take_shard)

__all__ = ["Zero3", "named_leaves", "tree_shapes"]


def named_leaves(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` of a nested dict in sorted-key order (the order
    of ``repro_torch.optim._slices.leaves``), paths joined by "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_shapes(tree) -> dict:
    return {p: tuple(x.shape) for p, x in named_leaves(tree)}


def _map(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


class Zero3:
    """The ZeRO-3 layout of a parameter tree on this rank of ``mesh``,
    with the collectives that gather, reduce and measure its shards over
    ``backend`` (the sums over the world run over the mesh's ranks).
    ``shapes`` are the whole leaves' ``{path: shape}`` in leaf order
    (:func:`tree_shapes`); the methods that take a list of shards take
    them in that order (``optim._slices.leaves``)."""

    def __init__(self, mesh, backend: str, shapes: dict):
        axes = mesh_axes(mesh)
        self._setup(axes, mesh_coords(mesh), shapes,
                    {a: CPComm(backend, mesh.get_group(a))
                     for a in axes if axes[a] > 1},
                    CPComm(backend, mesh_world(mesh)))

    @classmethod
    def from_layout(cls, axes: dict, coords: dict, shapes: dict,
                    comm_of) -> "Zero3":
        """The layout of the rank at ``coords`` of a mesh of ``axes``
        (``{axis: size}`` in axis order), with ``comm_of(axis)`` the
        communicator of its line along ``axis`` and ``comm_of(None)``
        that of every rank: no process group is needed."""
        self = cls.__new__(cls)
        self._setup(dict(axes), dict(coords), shapes,
                    {a: comm_of(a) for a in axes if axes[a] > 1},
                    comm_of(None))
        return self

    def _setup(self, axes: dict, coords: dict, shapes: dict, comms: dict,
               world) -> None:
        self.axes, self.coords = axes, coords
        self.comms = comms
        self.world = world
        self.shapes = dict(shapes)
        self.paths = list(self.shapes)
        self.specs = param_specs(self.axes, self.shapes)

    @property
    def cp(self) -> CPComm | None:
        """This rank's CP group (its ``model`` row), None at one rank."""
        return self.comms.get("model")

    def _spec(self, path: str, layer: bool) -> tuple:
        spec = self.specs[path]
        if layer:                   # one layer of a stacked leaf
            assert spec[0] is None, f"{path} is split on its layer dim"
            return spec[1:]
        return spec

    def _owns(self, path: str) -> bool:
        """Whether this rank counts ``path`` in a sum over the world: its
        coordinate is 0 on every axis the leaf is whole on."""
        return all(self.coords[a] == 0
                   for a in replicated_axes(self.specs[path], self.axes))

    # ---------------------------------------------------------------- #
    # layout
    # ---------------------------------------------------------------- #
    def shard_leaf(self, path: str, x):
        """This rank's shard of the whole leaf ``x`` at ``path``: a fresh
        contiguous tensor, so the whole leaf can be freed."""
        return take_shard(x, self.specs[path], self.axes, self.coords).clone(
            memory_format=torch.contiguous_format)

    def shard(self, tree):
        """This rank's shards of a tree of whole leaves."""
        return _map(tree, self.shard_leaf)

    def shard_shapes(self) -> dict:
        return {p: shard_shape(s, self.specs[p], self.axes)
                for p, s in self.shapes.items()}

    # ---------------------------------------------------------------- #
    # collectives
    # ---------------------------------------------------------------- #
    def _gather_leaf(self, x, spec, keep: tuple = ()):
        """``x`` gathered over the axes of ``spec`` (those of size > 1),
        but not over the axes in ``keep``."""
        for dim, e in enumerate(spec):
            if e is None:
                continue
            for a in reversed(e if isinstance(e, tuple) else (e,)):
                if a in self.comms and a not in keep:
                    x = all_gather_tiled(x, self.comms[a], dim)
        return x

    def gather(self, prefix: str, tree, *, experts: bool = False):
        """The whole leaves of this rank's shards ``tree`` at ``prefix``
        (differentiable: the backward reduce-scatters).  Under
        ``layers/`` the shards are one layer's slices of the stacked
        leaves, and an expert leaf stays split over ``model`` unless
        ``experts`` (a decode step, which routes with every expert)."""
        layer = prefix.startswith("layers")

        def one(p, x):
            keep = ("model",) if not experts and is_expert_leaf(
                p, len(self.shapes[p])) else ()
            return self._gather_leaf(x, self._spec(p, layer), keep)
        return _map(tree, one, f"{prefix}/")

    @torch.no_grad()
    def gather_full(self, tree):
        """The whole leaves of a tree of this rank's shards (every rank
        must call it; no gradient)."""
        return _map(tree, lambda p, x: self._gather_leaf(x, self.specs[p]))

    @torch.no_grad()
    def gather_state(self, state: dict, keep: bool = True) -> dict | None:
        """``{"params", "opt"}`` of this rank's shards -> the same of
        whole leaves on the host, one leaf whole on the device at a time
        (every rank must call it; only ranks that ``keep`` get it)."""
        def one(p, x):
            full = self._gather_leaf(x, self.specs[p])
            return full.cpu() if keep else None
        opt = state["opt"]
        whole = {k: _map(v, one) for k, v in opt.items() if k != "count"}
        whole["count"] = opt["count"].cpu()
        out = {"params": _map(state["params"], one), "opt": whole}
        return out if keep else None

    @torch.no_grad()
    def reshard_state(self, state: dict, other: "Zero3") -> dict:
        """``{"params", "opt"}`` of this layout's shards -> the same in
        ``other``'s layout of the same ranks (a dispatch degree switch),
        leaf by leaf: each leaf is gathered whole on the device, cut to
        this rank's new shard and dropped before the next (every rank
        must call it)."""
        def one(p, x):
            return other.shard_leaf(p, self._gather_leaf(x, self.specs[p]))
        opt = {k: v if k == "count" else _map(v, one)
               for k, v in state["opt"].items()}
        return {"params": _map(state["params"], one), "opt": opt}

    def reduce_grads_(self, grads: list) -> None:
        """Sum each gradient shard over the axes its leaf is whole on, in
        place."""
        for a, comm in self.comms.items():
            mine = [g for p, g in zip(self.paths, grads)
                    if a in replicated_axes(self.specs[p], self.axes)]
            if mine:
                all_reduce_(mine, comm)

    def global_norm(self, grads: list) -> torch.Tensor:
        """sqrt(Σ g²) over the whole leaves of the gradient shards, in
        f32: each rank adds the leaves it owns, then a sum over the
        world."""
        total = torch.zeros((1,), dtype=torch.float32,
                            device=grads[0].device)
        for p, g in zip(self.paths, grads):
            if self._owns(p):
                total += sum_of_squares(g)
        all_reduce_([total], self.world)
        return torch.sqrt(total[0])

    def leaf_amax(self, xs: list) -> list:
        """Each leaf's largest |x| over its whole leaf: a max over the
        world, which replicas do not change."""
        local = torch.stack([x.abs().max() for x in xs])
        all_reduce_([local], self.world, op=torch.distributed.ReduceOp.MAX)
        return list(local)

    def leaf_kth(self, xs: list, ks: list) -> list:
        """Each leaf's k-th largest |x| over its whole leaf, exactly,
        without gathering it: it lies among the union of every shard's
        own k largest, gathered over the world (ranks that do not own a
        leaf send -1, below every |x|)."""
        tops, widths = [], []
        for p, x, k in zip(self.paths, xs, ks):
            a = x.abs().reshape(-1)
            top = torch.topk(a, min(k, a.numel())).values
            tops.append(top if self._owns(p) else torch.full_like(top, -1.0))
            widths.append(top.numel())
        every = all_gather_tiled(torch.cat(tops)[None], self.world, 0)
        out, off = [], 0
        for k, w in zip(ks, widths):
            cand = every[:, off:off + w].reshape(-1)
            out.append(torch.topk(cand, k).values[-1])
            off += w
        return out

    def numels(self) -> list:
        """The whole leaves' element counts."""
        return [math.prod(s) for s in self.shapes.values()]
