"""Sharding rules as pure shape functions (the port of the reference's
``repro.runtime.sharding``).

Parameters are fully sharded over every mesh axis (ZeRO-3): each leaf
gets its largest divisible dims assigned greedily to the mesh axes, the
largest axis first.  Stacked layer leaves (a leading period dim) never
shard dim 0, so layer i of a shard, gathered, is layer i whole.  The MoE
expert leaves (``moe/wi``, ``moe/wg``, ``moe/wo``; (nP, E, d, f)) split
their expert dim over ``model``, the layout the expert-parallel island
computes in, and their other dims greedily over the other axes.

A *spec* has one entry per dim of a leaf: ``None`` (not split), an axis
name, or a tuple of axis names (split over their flattened product,
the first axis the major one), as a JAX ``PartitionSpec`` has.  Meshes
are ``{axis: size}`` dicts in axis order, ``("data", "model")`` or
``("pod", "data", "model")``: rows of a batch go over ``pod`` and
``data``, tokens over ``model`` (the CP axis).  Decode
caches (:func:`cache_specs`) put their batch over the batch axes
(:func:`batch_axes_of`: ``pod`` and ``data`` where the mesh has them)
and their largest dim that ``model`` divides over ``model``.
"""

from __future__ import annotations

import math

__all__ = ["TOKEN_KEYS", "leaf_spec", "expert_spec", "is_expert_leaf", "param_specs",
           "batch_specs", "batch_axes_of", "cache_specs", "spec_axes",
           "replicated_axes", "shard_index", "shard_shape", "take_shard"]


#: batch keys with one entry per token: (B, C) or (B, C, d), their
#: columns split over ``model``
TOKEN_KEYS = ("tokens", "labels", "doc", "pos", "perm", "frame_embeds",
              "patch_embeds", "patch_mask")


def _size(axes: dict, entry) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axes[a] for a in names)


def leaf_spec(shape, axes: dict, *, skip_dim0: bool) -> tuple:
    """The reference's ``_leaf_spec``: per mesh axis (largest first; ties
    in axis order), the largest not-yet-split dim it divides, else stacked
    onto an already-split dim that its size still divides, else none."""
    order = sorted(axes, key=lambda a: -axes[a])
    dims: list = [None] * len(shape)
    start = 1 if skip_dim0 and len(shape) > 1 else 0
    used: set[int] = set()
    for ax in order:
        size = axes[ax]
        if size == 1:
            continue
        cand = [i for i in range(start, len(shape))
                if i not in used and shape[i] % size == 0
                and shape[i] >= size]
        if not cand:
            for i in sorted(used, key=lambda i: -shape[i]):
                cur = dims[i] if isinstance(dims[i], tuple) else (dims[i],)
                if shape[i] % (_size(axes, cur) * size) == 0:
                    dims[i] = cur + (ax,)
                    break
            continue
        best = max(cand, key=lambda i: shape[i])
        dims[best] = ax
        used.add(best)
    return tuple(dims)


def expert_spec(shape, axes: dict) -> tuple:
    """The reference's ``_expert_spec``: the expert dim (1 of a stacked
    (nP, E, d, f) leaf, else 0) over ``model`` where E divides by it; each
    other axis of size > 1 (largest first) on the largest later dim it
    divides."""
    dims: list = [None] * len(shape)
    e_dim = 1 if len(shape) >= 4 else 0
    if shape[e_dim] % axes["model"] == 0:
        dims[e_dim] = "model"
    used = {e_dim}
    rest = [a for a in axes if a != "model" and axes[a] > 1]
    for ax in sorted(rest, key=lambda a: -axes[a]):
        cand = [i for i in range(e_dim + 1, len(shape))
                if i not in used and shape[i] % axes[ax] == 0]
        if cand:
            best = max(cand, key=lambda i: shape[i])
            dims[best] = ax
            used.add(best)
    return tuple(dims)


def is_expert_leaf(path: str, ndim: int) -> bool:
    """Whether the leaf at ``path`` ("/"-joined keys) is an expert weight
    (the reference's path test in ``param_shardings``)."""
    keys = path.split("/")
    return "moe" in keys and keys[-1] in ("wi", "wg", "wo") and ndim >= 3


def param_specs(axes: dict, shapes: dict) -> dict:
    """``{path: spec}`` for ``{path: shape}`` of a parameter or optimizer
    tree (the reference's ``param_shardings``): 0-d leaves replicated,
    expert leaves by :func:`expert_spec`, other leaves of two or more
    dims keep dim 0 whole."""
    def one(path, shape):
        if not len(shape):
            return ()
        if is_expert_leaf(path, len(shape)):
            return expert_spec(shape, axes)
        return leaf_spec(shape, axes, skip_dim0=len(shape) >= 2)
    return {path: one(path, shape) for path, shape in shapes.items()}


def batch_specs(axes: dict, batch_shapes: dict) -> dict:
    """Specs of the training batch's keys (the reference's
    ``batch_specs``): rows over the batch axes (:func:`batch_axes_of`:
    ``pod`` and ``data`` where the mesh has them, ``pod`` the major one)
    unless the row count does not divide by their product (then every
    rank of them takes every row), token columns (of the token keys and
    of the frontends' per-token embeddings and mask) and the per-rank
    table and ``send_idx`` axis over ``model``; a dispatch batch's
    per-row ``seq_tokens`` and ``group_id`` by row."""
    baxes = batch_axes_of(axes)
    B = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    need = _size(axes, B) if B else 1
    specs = {}
    for key, shape in batch_shapes.items():
        ndim = len(shape)
        rows = shape[0] if ndim else 1
        b = B if rows % need == 0 else None
        if key in TOKEN_KEYS:
            specs[key] = (b, "model") + (None,) * (ndim - 2)
        elif key == "send_idx":
            specs[key] = (b, "model", None)
        elif key in ("gath_doc", "gath_pos"):
            specs[key] = (b, None)
        elif key.startswith("tab_"):
            specs[key] = (b, "model") + (None,) * (ndim - 2)
        else:
            specs[key] = (b,) + (None,) * (ndim - 1)
    return specs


def batch_axes_of(axes: dict) -> tuple[str, ...]:
    """The mesh axes a batch is split over, major first."""
    return tuple(a for a in ("pod", "data") if a in axes)


def cache_specs(axes: dict, cache_shapes: dict) -> dict:
    """Specs of the decode cache's ``{path: shape}`` (the reference's
    ``cache_specs``): dim 0 is the period stack, dim 1 the batch, which
    goes over the batch axes where it divides by their product; the
    largest dim from 2 on that ``model`` divides (the KV stripes' S, a
    recurrent state's feature axis; the first of equal ones) goes over
    ``model``."""
    b = batch_axes_of(axes)
    B = b if len(b) > 1 else (b[0] if b else None)
    need = _size(axes, B) if B else 1
    msize = axes["model"]

    def one(shape):
        dims: list = [None] * len(shape)
        if len(shape) > 1 and B and shape[1] % need == 0:
            dims[1] = B
        cand = [i for i in range(2, len(shape))
                if shape[i] % msize == 0 and shape[i] >= msize]
        if cand:
            dims[max(cand, key=lambda i: shape[i])] = "model"
        return tuple(dims)
    return {path: one(tuple(shape)) for path, shape in cache_shapes.items()}


def spec_axes(spec) -> list[str]:
    """The mesh axes a spec splits over."""
    return [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]


def replicated_axes(spec, axes: dict) -> list[str]:
    """The axes (of size > 1) over which a leaf of this spec is whole on
    every rank."""
    split = set(spec_axes(spec))
    return [a for a, n in axes.items() if n > 1 and a not in split]


def shard_index(entry, axes: dict, coords: dict) -> int:
    """Which of the ``_size(entry)`` pieces of a dim the rank at
    ``coords`` holds (the first axis of a tuple entry the major one)."""
    idx = 0
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        idx = idx * axes[a] + coords[a]
    return idx


def shard_shape(shape, spec, axes: dict) -> tuple:
    return tuple(n if e is None else n // _size(axes, e)
                 for n, e in zip(shape, spec))


def take_shard(x, spec, axes: dict, coords: dict):
    """The rank at ``coords``'s piece of ``x`` (a tensor or an array)
    under ``spec``: a view."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = x.shape[dim] // _size(axes, e)
        i = shard_index(e, axes, coords)
        x = x[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]
    return x
