"""Rank body of the dry-run tests (torch and numpy only, so the spawned
ranks never import JAX).

``recording_rank`` runs the flashcp island of ``tests/_torch_cp_ranks.py``'s
batch (plain attention, chunked and monolithic) twice on each rank: on
the CPU over the rank's gloo ``CPComm``, and on ``meta`` copies of the
same inputs over a ``RecordingComm`` of the same rank and size, and
records both communicators' bytes by collective kind, after the forward
and after the backward.  It also decodes two steps of the smoke
starcoder2_3b (f32) with the attention cache's S axis split over the
ranks (``decode_step(cache_comm=...)``, the dry run's decode) and
records the largest difference of the logits from the whole cache's.
It writes ``<out_dir>/rank<r>.json``.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_cp_ranks import D, island_inputs, permute, plan_stack
from repro_torch.core.comm import RecordingComm
from repro_torch.core.cp_attention import make_cp_context
from repro_torch.launch.ranks import init_rank

OVERLAPS = ("chunked", "none")


def _island_bytes(comm, overlap, inputs, device) -> dict:
    """The flashcp island's forward and forward + backward bytes by kind
    on ``comm``, its inputs on ``device``."""
    N, r = comm.size, comm.rank
    stack = plan_stack("flashcp", N)
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in stack.items() if k != "perm"}
    perm = stack["perm"]
    t_loc = perm.shape[1] // N
    my = slice(r * t_loc, (r + 1) * t_loc)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        permute(x, perm)[:, :, my])).to(device).requires_grad_(True)
        for x in inputs[:3])
    ctx = make_cp_context(arrays, strategy="flashcp", impl="plain",
                          head_dim=D, q_chunk=64, overlap=overlap,
                          comm=comm)
    comm.reset_wire()
    out = ctx.attn(q, k, v)
    fwd = dict(comm.wire_bytes_by_kind)
    torch.autograd.grad(torch.sum(out.float() ** 2), (q, k, v))
    return {"forward": fwd, "all": dict(comm.wire_bytes_by_kind),
            "buf_len": int(stack["send_idx"].shape[-1])}


def _split_decode_err(comm) -> float:
    """Two decode steps on this rank's S slice of every attention cache
    (the new K/V written by the rank that holds the position, partials
    merged over the group) against the same steps on the whole cache."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import decode_step, init_cache, init_params

    cfg = reduce_for_smoke(get_config("starcoder2_3b"))
    params = init_params(cfg, seed=0, device="cpu")
    B, S = 3, 64
    gen = torch.Generator().manual_seed(0)
    whole = init_cache(cfg, B, S, device="cpu")
    for sub in whole.values():
        for x in sub.values():
            x.copy_(torch.randn(x.shape, generator=gen))
    S_l = S // comm.size
    mine = {j: {k: x[:, :, :, comm.rank * S_l:(comm.rank + 1) * S_l]
                .clone() for k, x in sub.items()}
            for j, sub in whole.items()}
    err = 0.0
    for pos in ([5, 17, 40], [6, 33, 63]):
        pos_t = torch.tensor(pos, dtype=torch.int32)
        toks = {"tokens": torch.tensor([1, 2, 3])}
        want, _ = decode_step(params, cfg, whole, toks, pos_t,
                              attn_impl="dense")
        got, _ = decode_step(params, cfg, mine, toks, pos_t,
                             attn_impl="dense", cache_comm=comm)
        err = max(err, float((got - want).abs().max()))
    return err


def recording_rank(rank, world, store, out_dir):
    comm, _ = init_rank(rank, world, "gloo", store, "cpu")
    torch.set_num_threads(1)
    try:
        inputs = island_inputs()
        out = {}
        for overlap in OVERLAPS:
            out[overlap] = {
                "real": _island_bytes(comm, overlap, inputs, "cpu"),
                "recorded": _island_bytes(RecordingComm(rank, world),
                                          overlap, inputs, "meta")}
        out["split_decode_err"] = _split_decode_err(comm)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
