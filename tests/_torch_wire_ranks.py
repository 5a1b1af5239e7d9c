"""Rank bodies of the int8 KV wire and sharded-decode tests (torch and
numpy only, so the spawned ranks never import JAX).

``wire_rank`` runs the CP islands of ``tests/_torch_cp_ranks.py``'s
batch on the native and the int8 wire, recording the bytes each rank's
``CPComm`` sent by pass and, for the wire audit, the forward's by
collective kind; ``decode_rank`` joins its group
through env:// and runs the sharded flash decode.  Each writes its
results to ``<out_dir>/rank<r>.npz``."""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_cp_ranks import (BK, BQ, D, island_inputs, permute, plan_stack)
from repro_torch.core.comm import dequantize_int8, quantize_int8
from repro_torch.core.cp_attention import make_cp_context, resolve_overlap
from repro_torch.launch.ranks import init_rank
from repro_torch.planner import emit_visit_tables, get_planner

#: ``native@dq``: the native wire on K/V already quantized and
#: dequantized, which the int8 wire's straight-through backward equals;
#: ``native@2buf``: the native wire with the Eq.-5 buffer twice as wide
#: as the plan needs (a fault the wire audit must catch)
WIRES = ("native", "int8", "native@dq", "native@2buf")


def case_key(plan_name, overlap, impl, grid, wire):
    return f"{plan_name}/{overlap}/{impl}/{grid}/{wire}"


def dq(x):
    """x quantized and dequantized per row of its last axis."""
    return dequantize_int8(*quantize_int8(x), x.dtype)


def _run(comm, plan_name, overlap, impl, grid, wire, inputs):
    strat = get_planner(plan_name).info.exec_style
    N, r = comm.size, comm.rank
    stack = plan_stack(plan_name, N, 2 if wire == "native@2buf" else 1)
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
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        permute(x, perm)[:, :, my])) for x in inputs[:3])
    if wire == "native@dq":
        k, v = dq(k), dq(v)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ctx = make_cp_context(arrays, strategy=strat, impl=impl, head_dim=D,
                          q_chunk=64, overlap=overlap, block_q=BQ,
                          block_k=BK, grid=grid,
                          kv_comm_dtype="int8" if wire == "int8"
                          else "native", comm=comm)
    comm.reset_wire()
    out = ctx.attn(q, k, v)
    by_kind = {"by_kind": dict(comm.wire_bytes_by_kind),
               "peak": dict(comm.wire_peak_by_kind),
               "buf_len": int(stack["send_idx"].shape[-1]
                              if strat in ("flashcp", "contiguous")
                              else t_loc)}
    grads = torch.autograd.grad(torch.sum(out.float() ** 2), (q, k, v))
    return [out.detach().numpy(), *(g.numpy() for g in grads)], \
        {**comm.wire_bytes, **by_kind}


def wire_rank(rank, world, store, out_dir, cases):
    """Every (island case, wire) at this CP size: o, dq, dk, dv slices,
    and the K/V bytes this rank handed to its CPComm per pass.  One
    thread per rank, as in ``_torch_cp_ranks.island_rank``."""
    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        inputs = island_inputs()
        res, nbytes = {}, {}
        for case in cases:
            outs, nbytes[case_key(*case)] = _run(comm, *case, inputs)
            key = case_key(*case)
            res.update({f"{key}/{n}": x
                        for n, x in zip(("o", "dq", "dk", "dv"), outs)})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        with open(os.path.join(out_dir, f"bytes{rank}.json"), "w") as f:
            json.dump(nbytes, f)
    finally:
        dist.destroy_process_group()


def decode_inputs(seed: int = 0):
    """q (B, Hq, D), k, v (B, Hkv, S, D) of the reference's
    decode_cp_check.py shapes, f32, from a seed."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, S, Dh = 4, 4, 2, 128, 16
    return (rng.standard_normal((B, Hq, Dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32))


def decode_rank(rank, world, port, out_dir, lens_cases):
    """One rank joined through env:// (the variables a launcher sets):
    its S-slice of the cache, per length mix the sharded decode's output
    and the merged partial; then, at 4 ranks, what
    ``make_production_mesh`` says of a world of 4, one pod and two."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_ranks,
                                                  local_lengths)
    from repro_torch.core.merge import merge_partials_axis

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    comm, _ = init_rank(rank, world, "gloo", None, "cpu")
    torch.set_num_threads(1)
    try:
        q, k, v = (torch.from_numpy(x) for x in decode_inputs())
        S_l = k.shape[2] // world
        ks = k[:, :, rank * S_l:(rank + 1) * S_l].contiguous()
        vs = v[:, :, rank * S_l:(rank + 1) * S_l].contiguous()
        res = {}
        for name, lens in lens_cases.items():
            ln = torch.tensor(lens, dtype=torch.int32)
            res[f"{name}/out"] = flash_decode_ranks(q, ks, vs, ln,
                                                    comm=comm).numpy()
            part = flash_decode(q, ks, vs,
                                local_lengths(ln, rank * S_l, S_l),
                                partial=True)
            for n, x in zip("oml", merge_partials_axis(part, comm)):
                res[f"{name}/{n}"] = x.numpy()
        info = {"backend": comm.backend, "rank": dist.get_rank()}
        if world == 4:
            from repro_torch.launch.mesh import make_production_mesh
            for key, pods in (("production", False), ("multi_pod", True)):
                try:
                    make_production_mesh(multi_pod=pods, device_type="cpu")
                except ValueError as err:
                    info[key] = str(err)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
        with open(os.path.join(out_dir, f"info{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()


def _dump_losses(out_dir, rank, out) -> None:
    """The rank's losses; under ``--autotune`` also the pick and the
    knobs the rank trained with (``autotune<r>.json``)."""
    with open(os.path.join(out_dir, f"losses{rank}.json"), "w") as f:
        json.dump([float(x) for x in out["losses"]], f)
    if "autotune" in out:
        from repro_torch.launch.train import TUNED_KNOBS
        run = out.get("run")
        with open(os.path.join(out_dir, f"autotune{rank}.json"), "w") as f:
            json.dump({"autotune": out["autotune"],
                       "trained_with": None if run is None else
                       {k: getattr(run, k) for k in TUNED_KNOBS}}, f)


def train_env_rank(rank, world, port, out_dir, argv):
    """One process of an env:// launch: the launcher's variables, then
    the CLI's ``main`` itself (which joins and starts nothing)."""
    from repro_torch.launch.train import main

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE":
                       str(world), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    _dump_losses(out_dir, rank, main(argv))


def train_file_rank(rank, world, store, out_dir, argv):
    """One rank of the CLI's own FileStore spawn."""
    from repro_torch.launch.train import _rank_main, build_parser

    _dump_losses(out_dir, rank,
                 _rank_main(rank, build_parser().parse_args(argv), world,
                            store))
