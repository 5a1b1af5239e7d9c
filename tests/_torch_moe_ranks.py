"""Rank bodies of the port's MoE tests (torch and numpy only, so the
spawned ranks never import JAX).

:func:`ep_rank` runs the expert-parallel island of one CP rank over
gloo on the CPU and writes its results to ``<out_dir>/rank<r>.npz``; the
test process assembles the ranks' slices and holds them against the JAX
package's island.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cp_attention import make_cp_context
from repro_torch.launch.ranks import init_rank

# the island case: B rows of T tokens, E experts of width F, top-K routing
# skewed towards a few experts, so that a rank's buffers clip at cf 1.25
B, T, DM, F, E, K = 2, 64, 16, 32, 8, 2
EP_CF = 1.25


def ep_inputs():
    """x, topi, gates, the output weights w of the test loss sum(out * w),
    and the expert weights wi, wg, wo, from seed 0."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, DM)).astype(np.float32)
    pref = np.array([8, 6, 1, 1, 1, 1, 1, 1], np.float64)
    topi = np.stack([rng.choice(E, K, replace=False, p=pref / pref.sum())
                     for _ in range(B * T)]).reshape(B, T, K)
    gates = rng.uniform(0.1, 1.0, (B, T, K))
    gates = (gates / gates.sum(-1, keepdims=True)).astype(np.float32)
    w = rng.standard_normal((B, T, DM)).astype(np.float32)
    wi, wg = (rng.standard_normal((E, DM, F)).astype(np.float32) / 4
              for _ in range(2))
    wo = rng.standard_normal((E, F, DM)).astype(np.float32) / 6
    return x, topi.astype(np.int32), gates, w, wi, wg, wo


def ep_rank(rank, world, store, out_dir):
    """This rank's island output and the gradients of sum(out * w) for its
    token slice (x, gates) and for its own E/N experts."""
    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        x, topi, gates, w, wi, wg, wo = ep_inputs()
        t_loc = T // world
        my = slice(rank * t_loc, (rank + 1) * t_loc)
        xs = torch.from_numpy(np.ascontiguousarray(x[:, my])) \
            .requires_grad_(True)
        gs = torch.from_numpy(np.ascontiguousarray(gates[:, my])) \
            .requires_grad_(True)
        ts = torch.from_numpy(np.ascontiguousarray(topi[:, my]))
        e_loc = E // world
        mine = slice(rank * e_loc, (rank + 1) * e_loc)
        weights = {n: torch.from_numpy(np.ascontiguousarray(a[mine]))
                   .requires_grad_(True)
                   for n, a in (("wi", wi), ("wg", wg), ("wo", wo))}
        params = {"router": torch.zeros((DM, E)), **weights}
        arrays = {"doc": torch.zeros((B, T), dtype=torch.int32),
                  "pos": torch.zeros((B, T), dtype=torch.int32),
                  "send_idx": torch.full((B, world, 16), -1)}
        ctx = make_cp_context(arrays, head_dim=8, comm=comm)
        out = ctx.extras["ep_dispatch"](xs, ts, gs, params, kind="glu",
                                        capacity_factor=EP_CF)
        loss = torch.sum(out * torch.from_numpy(
            np.ascontiguousarray(w[:, my])))
        grads = torch.autograd.grad(loss, [xs, gs, *weights.values()])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 out=out.detach().numpy(),
                 **{n: g.numpy() for n, g in zip(
                     ("dx", "dgates", "dwi", "dwg", "dwo"), grads)})
    finally:
        dist.destroy_process_group()
