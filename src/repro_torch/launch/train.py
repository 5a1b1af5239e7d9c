"""Training CLI of the port (the reference's ``repro.launch.train``
on a ``1xN`` mesh).

Wires the data pipeline (document packing, the planner, plan order,
visit tables) to the training step (doc-masked attention through the
CUDA kernels, AdamW with an fp32 master).  ``--mesh 1xN`` with N > 1
runs context parallelism over N ranks that this CLI starts itself
(``torch.multiprocessing``, a ``FileStore`` rendezvous in a temporary
directory), with the backend named by ``--dist-backend``; rank r runs on
``cuda:(r % device_count)``, or on the CPU with ``--device cpu``.
CPU-scale examples (the kernels' plain twins on CPU tensors):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --seq-len 512 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --mesh 1x4 --dist-backend gloo --steps 3 --seq-len 512

Full width on one H100 (random weights from the seed):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --seq-len 8192 --batch 1 --steps 4

Data parallelism (a data axis > 1), checkpointing, elastic supervision,
dispatch, autotuning and the background prefetcher wait for later slices
of the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core.comm import CPComm, broadcast_
from repro_torch.data.pipeline import PipelineConfig, exec_style_of, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import init_rank, spawn_ranks
from repro_torch.launch.steps import batch_to_device, build_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.optim._slices import leaves

__all__ = ["train", "build_parser", "main", "parse_mesh"]


def parse_mesh(mesh: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model); only a data axis of 1 runs yet."""
    try:
        data, model = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r}: expected DxM, e.g. 1x4") \
            from None
    if data != 1:
        raise NotImplementedError(
            f"--mesh {mesh}: a data axis > 1 (data parallelism with "
            "ZeRO-3/FSDP sharding) comes with a later slice of the port")
    if model < 1:
        raise ValueError(f"--mesh {mesh}: the model axis must be >= 1")
    return data, model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args, params=None, comm: CPComm | None = None,
          device=None) -> dict:
    """Run ``args.steps`` training steps; returns the per-step losses,
    grad norms, LRs, token counts and wall times, plus the final
    ``params``, ``opt_state``, ``step_fn`` and ``pipeline`` config so a
    caller can run further steps.  ``params`` (on the device) replaces
    the seeded initialization: a CUDA generator and a CPU one draw
    different numbers from the same seed.  ``comm`` makes this process
    one rank of a CP group of ``comm.size`` (on ``device``): every rank
    draws the parameters from the same seed, a checksum against rank 0's
    proves the replicas equal, and only rank 0 logs."""
    dev = resolve_device(device or getattr(args, "device", "cuda"))
    cp = 1 if comm is None else comm.size
    if parse_mesh(getattr(args, "mesh", "1x1"))[1] != cp:
        raise ValueError(f"--mesh {args.mesh} on a group of {cp} ranks: "
                         "main() starts the ranks of a CP mesh")
    log = comm is None or comm.rank == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if getattr(args, "layers", 0):
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    exec_style_of(args.strategy)    # unknown strategies fail fast
    run = RunConfig(arch=args.arch, cp_strategy=args.strategy,
                    attention_impl=args.attention_impl,
                    kernel_grid=args.grid, lr=args.lr,
                    total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    remat=not args.no_remat, seed=args.seed)
    flash = run.attention_impl == "flash"
    pipe = PipelineConfig(
        dataset=args.dataset, context_len=args.seq_len,
        batch_per_host=args.batch, cp_size=cp, strategy=args.strategy,
        vocab_size=cfg.vocab_size, seed=run.seed,
        # the kernels need block-divisible sequences
        align=128 if flash else 1, emit_tables=flash,
        table_overlap=run.cp_overlap, table_grid=run.kernel_grid)
    step_fn = build_train_step(cfg, run, q_chunk=args.q_chunk, device=dev,
                               comm=comm)
    if params is None:
        params = init_params(cfg, seed=run.seed, device=dev)
    if comm is not None:
        # the replicas must start equal (same seed, same device type)
        mine = torch.stack([p.detach().double().sum()
                            for p in leaves(params)]).sum().reshape(1)
        first = mine.clone()
        broadcast_([first], comm)
        if not torch.equal(mine, first):
            raise RuntimeError(f"CP rank {comm.rank} holds other parameters "
                               "than rank 0")
    opt_state = adamw_init(params)

    out = {"losses": [], "grad_norms": [], "lrs": [], "tokens": [],
           "step_s": []}
    for step in range(args.steps):
        t0 = time.perf_counter()
        batch = make_batch(pipe, step)
        metrics = step_fn(params, opt_state, batch_to_device(batch, dev),
                          step)
        loss = float(metrics["loss"])          # waits for the step
        _sync(dev)
        dt = time.perf_counter() - t0
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["lrs"].append(float(metrics["lr"]))
        out["tokens"].append(int(metrics["tokens"]))
        out["step_s"].append(dt)
        if log and step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"imb {batch['stats']['imbalance']:.3f} "
                  f"comm_tok {batch['stats']['comm_tokens']} "
                  f"{dt:.2f}s", flush=True)
    out.update(final_step=args.steps, params=params, opt_state=opt_state,
               step_fn=step_fn, pipeline=pipe, config=cfg, run=run)
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
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM: data x model (CP) axes; D must be 1")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    help="collective backend, required when M > 1 (gloo "
                         "where ranks share a card: NCCL takes one rank "
                         "per device)")
    return ap


def _report(out) -> None:
    if out["losses"]:
        print(f"[train] done at step {out['final_step']}; "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}",
              flush=True)


def _rank_main(rank: int, args, world: int, store: str) -> None:
    import torch.distributed as dist

    comm, dev = init_rank(rank, world, args.dist_backend, store, args.device)
    try:
        out = train(args, comm=comm, device=dev)
        if rank == 0:
            _report(out)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _, world = parse_mesh(args.mesh)
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
