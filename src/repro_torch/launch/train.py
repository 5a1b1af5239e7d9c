"""Training CLI of the port (the reference's ``repro.launch.train``
plain loop, without the elastic supervisor).

Wires the data pipeline (document packing, the planner, plan order,
visit tables) to the training step (doc-masked attention through the
CUDA kernels, AdamW with an fp32 master) and the checkpoints.
``--mesh DxM`` with D x M > 1 runs that many ranks, which this CLI
starts itself (``torch.multiprocessing``, a ``FileStore`` rendezvous in
a temporary directory), with the backend named by ``--dist-backend``;
rank r runs on ``cuda:(r % device_count)``, or on the CPU with
``--device cpu``.  The batch rows go over ``data``, each row's tokens
over ``model`` (context parallelism through the CP islands), and the
parameters and optimizer state are sharded over both (ZeRO-3).
CPU-scale examples (the kernels' plain twins on CPU tensors):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --seq-len 512 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --mesh 2x2 --dist-backend gloo --steps 3 --seq-len 512 \\
        --checkpoint-dir ckpt --ckpt-every 2

Full width on one H100 (random weights from the seed):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --seq-len 8192 --batch 1 --steps 4

The recurrent archs (``jamba_v0_1_52b``, ``xlstm_350m``) train on the
``contiguous`` planner whatever ``--strategy`` asks for, unless it
preserves token order (the scan state crosses the CP ranks in token
order); xlstm_350m has no attention, so no visit tables are built:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_350m \\
        --seq-len 8192 --batch 1 --steps 3

MoE archs (``olmoe_1b_7b``, ``dbrx_132b``) train the same way; on a mesh
their experts split over ``model`` and each layer's tokens reach them by
the expert-parallel all-to-all.  The log and the result carry the aux
load-balancing loss.  olmoe's 16 layers of training state (111 GB) do
not fit one card, so cut its depth:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b \\
        --layers 4 --seq-len 8192 --batch 1 --steps 3

Checkpoints are written only where ``--checkpoint-dir`` names a
directory (the reference defaults to ``/tmp/repro_ckpt``; the port
writes nothing its caller did not name).  Elastic supervision, dispatch
and autotuning wait for later slices of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core.comm import CPComm, broadcast_
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, mesh_axes
from repro_torch.launch.ranks import init_rank, spawn_ranks
from repro_torch.launch.steps import (batch_to_device, build_train_step,
                                      effective_strategy)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime.zero import Zero3, named_leaves, tree_shapes

__all__ = ["train", "build_parser", "main", "parse_mesh",
           "restore_state", "check_same_on_ranks"]


def parse_mesh(mesh: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model)."""
    try:
        data, model = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r}: expected DxM, e.g. 2x4") \
            from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {mesh}: both axes must be >= 1")
    return data, model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_same_on_ranks(mine: torch.Tensor, world: CPComm,
                        what: str) -> None:
    """Raise on every rank whose ``mine`` (a float64 checksum of ``what``)
    differs from rank 0's."""
    first = mine.clone()
    broadcast_([first], world)
    if not torch.equal(mine, first):
        raise RuntimeError(f"rank {world.rank} holds other {what} than "
                           "rank 0")


def _param_shapes(manifest: dict) -> dict:
    """A checkpoint's whole parameter leaves as ``{path: shape}``, in leaf
    order."""
    tree: dict = {}
    for key, a in manifest["arrays"].items():
        parts = key.split("/")
        if parts[0] == "params":
            node = tree
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = tuple(a["shape"])
    return dict(named_leaves(tree))


def restore_state(ckpt: CheckpointManager, step: int, mesh, backend,
                  dev) -> tuple:
    """(params, optimizer state, ZeRO-3 layout or None) of checkpoint
    ``step`` on ``dev``, as this rank of ``mesh`` (None: one rank) holds
    them.  Each leaf is cut to this rank's shard on the host as it is
    read (reshard-on-restore onto any mesh), so a rank never holds more
    than one whole leaf, and that on the host; on a mesh the whole
    parameters' checksum is held against rank 0's."""
    zero = None if mesh is None else \
        Zero3(mesh, backend, _param_shapes(ckpt.manifest(step)))
    sums = []

    def leaf(key: str, x: torch.Tensor) -> torch.Tensor:
        parts = key.split("/")      # params/<path>, opt/<slot>/<path>
        path = "/".join(parts[2:] if parts[0] == "opt" else parts[1:])
        if zero is not None and path in zero.specs:
            if parts[0] == "params":
                sums.append(x.sum(dtype=torch.float64))
            x = zero.shard_leaf(path, x)
        return x.to(dev)

    _, tree, _ = ckpt.restore(step, leaf=leaf)
    if zero is not None:
        check_same_on_ranks(torch.stack(sums).sum().reshape(1).to(dev),
                            zero.world, "restored parameters")
    return tree["params"], tree["opt"], zero


def _resume_step(ckpt, args, world: CPComm | None, dev) -> int | None:
    """The checkpoint to start from under ``--resume``: rank 0's latest
    (None when there is none), the same on every rank."""
    latest = ckpt.latest_step() if ckpt and args.resume else None
    step = torch.tensor([-1 if latest is None else latest],
                        dtype=torch.int64, device=dev)
    if world is not None:
        broadcast_([step], world)
    return None if int(step) < 0 else int(step)


def train(args, params=None, mesh=None, device=None) -> dict:
    """Run training steps up to ``args.steps``; returns the per-step
    losses, grad norms, LRs, token counts, MoE aux losses (0 for a dense
    model) and wall times, plus the final
    ``params``, ``opt_state``, ``step_fn``, ``pipeline`` config and (on
    a mesh) the ``zero`` layout, so a caller can run further steps.

    ``params`` (whole leaves, on the device) replaces the seeded
    initialization: a CUDA generator and a CPU one draw different
    numbers from the same seed.  ``mesh`` (``launch.mesh``) makes this
    process one rank of a ``--mesh`` of more than one rank, on
    ``device``; it then holds only its ZeRO-3 shards: every rank draws
    the same parameters from the seed (a checksum against rank 0's
    proves it) and keeps its shards, or restores its shards of a
    checkpoint (:func:`restore_state`); only rank 0 logs and writes
    checkpoints."""
    dev = resolve_device(device or getattr(args, "device", "cuda"))
    D, M = parse_mesh(getattr(args, "mesh", "1x1"))
    axes = {"data": 1, "model": 1} if mesh is None else mesh_axes(mesh)
    if axes != {"data": D, "model": M}:
        raise ValueError(f"--mesh {args.mesh} on a mesh of {axes}: main() "
                         "starts the ranks of a mesh")
    world = None if mesh is None else CPComm(args.dist_backend)
    rank = 0 if world is None else world.rank
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if getattr(args, "layers", 0):
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # unknown strategies fail fast; recurrent families swap for contiguous
    strategy = effective_strategy(cfg, args.strategy)
    run = RunConfig(arch=args.arch, cp_strategy=strategy,
                    attention_impl=args.attention_impl,
                    kernel_grid=args.grid, lr=args.lr,
                    total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    grad_compression=args.grad_compression,
                    checkpoint_dir=args.checkpoint_dir,
                    remat=not args.no_remat, seed=args.seed)
    flash = run.attention_impl == "flash"
    pipe = PipelineConfig(
        dataset=args.dataset, context_len=args.seq_len,
        batch_per_host=args.batch, cp_size=M, strategy=strategy,
        vocab_size=cfg.vocab_size, seed=run.seed,
        # the kernels need block-divisible rank slices
        align=128 if flash else (1 if M == 1 else 16),
        emit_tables=flash and cfg.uses_attention,
        table_overlap=run.cp_overlap, table_grid=run.kernel_grid)
    if (args.resume or args.ckpt_every) and not run.checkpoint_dir:
        raise ValueError("--resume and --ckpt-every need --checkpoint-dir")
    ckpt = CheckpointManager(run.checkpoint_dir, keep=2) \
        if run.checkpoint_dir else None
    resume = _resume_step(ckpt, args, world, dev)
    start, opt_state, zero = resume or 0, None, None
    if resume is not None:
        params, opt_state, zero = restore_state(
            ckpt, resume, mesh, args.dist_backend, dev)
        if rank == 0:
            print(f"[train] resumed from step {start}", flush=True)
    else:
        if params is None:
            params = init_params(cfg, seed=run.seed, device=dev)
        if mesh is not None:
            mine = torch.stack([x.sum(dtype=torch.float64)
                                for _, x in named_leaves(params)])
            check_same_on_ranks(mine.sum().reshape(1), world, "parameters")
            zero = Zero3(mesh, args.dist_backend, tree_shapes(params))
            params = zero.shard(params)
    if opt_state is None:
        opt_state = adamw_init(params)
    step_fn = build_train_step(cfg, run, q_chunk=args.q_chunk, device=dev,
                               zero=zero)

    def save(step: int, blocking: bool) -> None:
        state = {"params": params, "opt": opt_state}
        if zero is not None:
            state = zero.gather_state(state, keep=rank == 0)
        if rank == 0:
            ckpt.save(step, state, blocking=blocking)
        if blocking and world is not None:
            # every rank returns once rank 0 has committed the checkpoint
            broadcast_([torch.zeros((1,), device=dev)], world)

    it = Prefetcher(pipe, start_step=start) if args.prefetch else None
    out = {"losses": [], "grad_norms": [], "lrs": [], "tokens": [],
           "auxes": [], "step_s": []}
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = next(it) if it else make_batch(pipe, step)
            metrics = step_fn(params, opt_state,
                              batch_to_device(batch, dev), step)
            loss = float(metrics["loss"])          # waits for the step
            _sync(dev)
            dt = time.perf_counter() - t0
            out["losses"].append(loss)
            out["grad_norms"].append(float(metrics["grad_norm"]))
            out["lrs"].append(float(metrics["lr"]))
            out["tokens"].append(int(metrics["tokens"]))
            out["auxes"].append(float(metrics["aux"]))
            out["step_s"].append(dt)
            if rank == 0 and step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"aux {float(metrics['aux']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"imb {batch['stats']['imbalance']:.3f} "
                      f"comm_tok {batch['stats']['comm_tokens']} "
                      f"{dt:.2f}s", flush=True)
            if ckpt and args.ckpt_every and step \
                    and step % args.ckpt_every == 0:
                save(step + 1, blocking=False)
        if ckpt:
            save(max(args.steps, start), blocking=True)
    finally:
        if it:
            it.close()
    out.update(final_step=max(args.steps, start), params=params,
               opt_state=opt_state, step_fn=step_fn, pipeline=pipe,
               config=cfg, run=run, zero=zero)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (depth only; "
                         "0 keeps the config's)")
    ap.add_argument("--strategy", default="flashcp")
    ap.add_argument("--attention-impl", default="flash",
                    choices=("flash", "plain"),
                    help="flash = the CUDA kernels (their plain twins on "
                         "the CPU); plain = chunked dense attention")
    ap.add_argument("--grid", default="flat", choices=("flat", "rect"),
                    help="kernel schedule over the visit tables")
    ap.add_argument("--dataset", default="wlb_llm")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--q-chunk", type=int, default=128)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "topk", "int8"),
                    help="compress the clipped gradients (zero error "
                         "feedback, as the reference does)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory of the checkpoints ('' = none)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save asynchronously after every this many steps "
                         "(0 = only the final save)")
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint, on any mesh")
    ap.add_argument("--prefetch", action="store_true",
                    help="build batches ahead on a background thread")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: data x model (CP) axes")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="collective backend, required when D x M > 1 "
                         "(gloo where ranks share a card: NCCL takes one "
                         "rank per device)")
    return ap


def _report(out) -> None:
    if out["losses"]:
        print(f"[train] done at step {out['final_step']}; "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}",
              flush=True)


def _rank_main(rank: int, args, world: int, store: str) -> None:
    import torch.distributed as dist

    _, dev = init_rank(rank, world, args.dist_backend, store, args.device)
    try:
        mesh = make_local_mesh(*parse_mesh(args.mesh),
                               device_type=dev.type)
        out = train(args, mesh=mesh, device=dev)
        if rank == 0:
            _report(out)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    data, model = parse_mesh(args.mesh)
    world = data * model
    if world == 1:
        _report(train(args))
        return
    if args.dist_backend is None:
        raise SystemExit(f"--mesh {args.mesh} needs --dist-backend "
                         "{nccl,gloo}")
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(_rank_main, world,
                    args=(args, world, os.path.join(tmp, "store")))


if __name__ == "__main__":
    main()
