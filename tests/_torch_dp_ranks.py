"""Rank bodies of the port's ZeRO-3 tests (torch and numpy only, so the
spawned ranks never import JAX).

Each runs as one rank of a gloo process group on the CPU and writes its
results to ``<out_dir>/rank<r>.npz``; the test process holds them
against the whole leaves.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.ranks import init_rank

# leaves that take every kind of spec on a 2x2 mesh: two axes on two
# dims, two axes stacked on one dim, one axis (whole over the other),
# none (whole over both); "layers/" leaves are stacked on dim 0
SHAPES = {"bias/b": (8,), "embed/e": (10, 4), "final/g": (5,),
          "head/w": (4, 8), "layers/sub_0/g": (3, 6),
          "layers/sub_0/w": (3, 8, 12)}
CLIP = 1.0


def nest(paths, xs) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for path, x in zip(paths, xs):
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def whole_tree(seed: int) -> dict:
    """Nested dict of f32 tensors of SHAPES, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return nest(SHAPES, [torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in SHAPES.values()])


def _weighted_sum(zero, shards, weights):
    """Σ whole * weight over every leaf, each leaf gathered where it is
    used as the transformer does (a stacked leaf one layer at a time)."""
    total = 0.0
    for key in sorted(shards):
        if key == "layers":
            sub, w = shards["layers"]["sub_0"], weights["layers"]["sub_0"]
            for i in range(SHAPES["layers/sub_0/w"][0]):
                got = zero.gather("layers/sub_0",
                                  {k: v[i] for k, v in sub.items()})
                total = total + sum((got[k] * w[k][i]).sum() for k in got)
        else:
            got = zero.gather(key, shards[key])
            total = total + sum((got[k] * weights[key][k]).sum()
                                for k in got)
    return total


def _refused(checksum) -> bool:
    """Whether ``train``'s check refuses this rank's ``checksum``."""
    from repro_torch.core.comm import CPComm
    from repro_torch.launch.train import check_same_on_ranks

    try:
        check_same_on_ranks(checksum, CPComm("gloo"), "parameters")
    except RuntimeError:
        return True
    return False


def zero_rank(rank, world, store, out_dir, mesh_shape):
    """This rank's shards of ``whole_tree(0)``; the whole leaves they
    gather to; the gradient of Σ_r Σ whole * whole_tree(100 + r) through
    the gathers (this rank's term only); the global norm of those
    gradient shards, the shards clipped to CLIP, and each compression
    scheme applied to the clipped shards, all gathered whole."""
    from repro_torch.optim import clip_by_global_norm, compress_tree
    from repro_torch.optim._slices import leaves
    from repro_torch.runtime.zero import Zero3, named_leaves

    init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        mesh = make_local_mesh(*mesh_shape, device_type="cpu")
        zero = Zero3(mesh, "gloo", SHAPES)
        shards = zero.shard(whole_tree(0))
        res = {f"shard/{p}": x.numpy() for p, x in named_leaves(shards)}
        res.update({f"whole/{p}": x.numpy() for p, x in
                    named_leaves(zero.gather_full(shards))})
        flat = leaves(shards)
        for x in flat:
            x.requires_grad_(True)
        loss = _weighted_sum(zero, shards, whole_tree(100 + rank))
        grads = list(torch.autograd.grad(loss, flat))
        zero.reduce_grads_(grads)
        # copies: clipping scales the gradients in place
        res.update({f"grad/{p}": g.numpy().copy()
                    for p, g in zip(zero.paths, grads)})
        norm = zero.global_norm(grads)
        res["norm"] = norm.numpy()
        tree, _ = clip_by_global_norm(nest(zero.paths, grads), CLIP,
                                      norm=norm)
        res.update({f"clipped/{p}": x.numpy() for p, x in
                    named_leaves(zero.gather_full(tree))})
        for scheme in ("topk", "int8"):
            sent, _ = compress_tree(tree, None, scheme, layout=zero)
            res.update({f"{scheme}/{p}": x.numpy() for p, x in
                        named_leaves(zero.gather_full(sent))})
        same, own = (torch.full((1,), float(v), dtype=torch.float64)
                     for v in (1, rank))
        res["refused"] = np.array([_refused(same), _refused(own)])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
