"""Rank bodies of the port's CP tests (torch and numpy only, so the
spawned ranks never import JAX).

Each runs as one rank of a gloo process group on the CPU and writes its
results to ``<out_dir>/rank<r>.npz``; the test process assembles the
ranks' slices and holds them against the JAX package.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.cp_attention import make_cp_context, resolve_overlap
from repro_torch.data.packing import doc_ids_and_positions
from repro_torch.launch.ranks import init_rank
from repro_torch.planner import (emit_visit_tables, encode_plan_batch,
                                 get_planner)

# the cases of tests/multidevice/overlap_check.py
C, B, HQ, HKV, D = 256, 2, 4, 2, 8
DOC_LENS = np.array([70, 23, 100, 40, 23], dtype=np.int64)
BQ = BK = 16


def island_inputs():
    """q0, k0, v0 (packed order) and the packed doc/pos, from seed 0."""
    rng = np.random.default_rng(0)
    gdoc, gpos = doc_ids_and_positions(DOC_LENS)
    gdoc = np.tile(gdoc, (B, 1)).astype(np.int32)
    gpos = np.tile(gpos, (B, 1)).astype(np.int32)
    q0 = rng.standard_normal((B, HQ, C, D)).astype(np.float32)
    k0 = rng.standard_normal((B, HKV, C, D)).astype(np.float32)
    v0 = rng.standard_normal((B, HKV, C, D)).astype(np.float32)
    return q0, k0, v0, gdoc, gpos


def permute(x, perm, axis=2):
    """Packed order -> plan order along ``axis`` (zeros at padding)."""
    safe = np.maximum(perm, 0)
    shp = [1] * x.ndim
    shp[0], shp[axis] = perm.shape[0], perm.shape[1]
    out = np.take_along_axis(x, safe.reshape(shp), axis=axis)
    return out * (perm >= 0).reshape(shp)


def plan_stack(plan_name: str, cp: int, buf_scale: int = 1):
    """The plan-order batch of ``plan_name`` at ``cp`` ranks; a
    ``buf_scale`` above 1 widens the Eq.-5 buffer that many times."""
    plans = [get_planner(plan_name)(DOC_LENS, cp) for _ in range(B)]
    stack, encs = encode_plan_batch(plans, align=BQ)
    if buf_scale != 1:
        stack, _ = encode_plan_batch(plans, align=BQ,
                                     buf_len=encs[0].buf_len * buf_scale)
    return stack


def island_case_key(plan_name, overlap, impl, grid):
    return f"{plan_name}/{overlap}/{impl}/{grid}"


def _run_island(comm, plan_name, overlap, impl, grid, inputs):
    strat = get_planner(plan_name).info.exec_style
    N, r = comm.size, comm.rank
    stack = plan_stack(plan_name, N)
    arrays = dict(stack)
    if impl == "flash":
        gath = strat in ("flashcp", "contiguous")
        arrays.update(emit_visit_tables(
            stack["doc"], stack["pos"],
            stack["gath_doc"] if gath else None,
            stack["gath_pos"] if gath else None, num_workers=N,
            strategy=strat, overlap=resolve_overlap(strat, "flash", overlap),
            grid=grid, block_q=BQ, block_k=BK))
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in arrays.items() if k != "perm"}
    perm = stack["perm"]
    t_loc = perm.shape[1] // N
    my = slice(r * t_loc, (r + 1) * t_loc)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(permute(x, perm)[:, :,
                                                                       my]))
               .requires_grad_(True) for x in inputs[:3])
    ctx = make_cp_context(arrays, strategy=strat, impl=impl, head_dim=D,
                          q_chunk=64, overlap=overlap, block_q=BQ,
                          block_k=BK, grid=grid, comm=comm)
    out = ctx.attn(q, k, v)
    grads = torch.autograd.grad(torch.sum(out.float() ** 2), (q, k, v))
    return [out.detach().numpy(), *(g.numpy() for g in grads)]


def island_rank(rank, world, store, out_dir, cases):
    """Every island case at this CP size; saves o, dq, dk, dv slices.
    One thread per rank: with several, the BLAS may split a product's
    reduction differently when the host is busy, and the results then
    move by f32 rounding between runs."""
    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        inputs = island_inputs()
        res = {}
        for case in cases:
            o, dq, dk, dv = _run_island(comm, *case, inputs)
            key = island_case_key(*case)
            res.update({f"{key}/o": o, f"{key}/dq": dq, f"{key}/dk": dk,
                        f"{key}/dv": dv})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def nest(flat: dict) -> dict:
    """{"a.b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def leaf_names(tree, prefix=""):
    """Dotted names of a nested dict's leaves in sorted-key order (the
    order of ``repro_torch.optim._slices.leaves``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def train_rank(rank, world, store, out_dir, params_file, pipe_kw, run_kw,
               cases, mesh_shape, arch="starcoder2_3b", cfg_kw=None):
    """The train step on a ``mesh_shape`` mesh of gloo ranks (ZeRO-3):
    (data, model), or (pod, data, model) for three sizes, on the smoke
    ``arch`` (its config fields replaced by ``cfg_kw``), from the
    converted parameters, for each (attention impl, gradient compression)
    case: whether this rank's shards are exactly its slices of the whole
    leaves, loss, metrics and the whole gradients of step 0's batch, then
    one train step's metrics and the whole updated parameters."""
    import dataclasses
    from repro_torch import configs as tcfgs
    from repro_torch import optim as topt
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.mesh import AXES, POD_AXES, make_mesh
    from repro_torch.launch.steps import batch_to_device, build_train_step
    from repro_torch.models import params_from_numpy
    from repro_torch.optim._slices import leaves
    from repro_torch.runtime.sharding import take_shard
    from repro_torch.runtime.zero import Zero3, named_leaves, tree_shapes

    init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)          # as in island_rank
    try:
        mesh = make_mesh(mesh_shape, AXES if len(mesh_shape) == 2
                         else POD_AXES, device_type="cpu")
        cfg = dataclasses.replace(
            tcfgs.reduce_for_smoke(tcfgs.get_config(arch)), **(cfg_kw or {}))
        with np.load(params_file) as f:
            flat = {k: f[k] for k in f.files}
        res = {}
        for impl, comp in cases:
            whole = params_from_numpy(nest(flat), device="cpu")
            names = leaf_names(whole)
            zero = Zero3(mesh, "gloo", tree_shapes(whole))
            params = zero.shard(whole)
            shards = dict(named_leaves(params))
            res[f"{impl}/{comp}/shards_exact"] = np.array(all(
                tuple(shards[p].shape) == s and torch.equal(
                    shards[p], take_shard(x, zero.specs[p], zero.axes,
                                          zero.coords))
                for (p, x), s in zip(named_leaves(whole),
                                     zero.shard_shapes().values())))
            run = tcfgs.RunConfig(arch=cfg.name, attention_impl=impl,
                                  grad_compression=comp, **run_kw)
            step_fn = build_train_step(cfg, run, q_chunk=64, block_q=64,
                                       block_k=64, device="cpu", zero=zero)
            pipe = PipelineConfig(**pipe_kw[impl], cp_size=mesh_shape[-1],
                                  vocab_size=cfg.vocab_size)
            batch = batch_to_device(make_batch(pipe, 0), "cpu")
            (loss, metrics), grads = step_fn.loss_and_grads(params, batch)
            key = f"{impl}/{comp}"
            res[f"{key}/loss"] = loss.numpy()
            res[f"{key}/ce"] = metrics["ce"].numpy()
            res[f"{key}/aux"] = metrics["aux"].numpy()
            res.update({f"{key}/grad/{n}": g.numpy() for n, g in
                        zip(names, leaves(zero.gather_full(grads)))})
            m = step_fn(params, topt.adamw_init(params), batch, 0)
            res.update({f"{key}/step/{k}": v.float().numpy()
                        for k, v in m.items()})
            res.update({f"{key}/param/{n}": p.detach().numpy() for n, p in
                        zip(names, leaves(zero.gather_full(params)))})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()
