"""Single-device training driver of the port (the reference's
``repro.launch.train`` at a 1x1 mesh).

Wires the data pipeline (document packing, plan order, visit tables)
to the training step (doc-masked attention through the CUDA kernels,
AdamW with an fp32 master) on one device.  CPU-scale example (the
kernels' plain twins on CPU tensors):

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 6 --seq-len 512 --batch 2

Full width on one H100 (random weights from the seed):

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b \\
        --seq-len 8192 --batch 1 --steps 4

Checkpointing, elastic supervision, dispatch, autotuning and the
background prefetcher wait for later slices of the port.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.data.pipeline import PipelineConfig, exec_style_of, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import batch_to_device, build_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

__all__ = ["train", "build_parser", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args, params=None) -> dict:
    """Run ``args.steps`` training steps; returns the per-step losses,
    grad norms, LRs, token counts and wall times, plus the final
    ``params``, ``opt_state``, ``step_fn`` and ``pipeline`` config so a
    caller can run further steps.  ``params`` (on the device) replaces
    the seeded initialization: a CUDA generator and a CPU one draw
    different numbers from the same seed."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
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
        batch_per_host=args.batch, cp_size=1, strategy=args.strategy,
        vocab_size=cfg.vocab_size, seed=run.seed,
        # the kernels need block-divisible sequences
        align=128 if flash else 1, emit_tables=flash,
        table_overlap=run.cp_overlap, table_grid=run.kernel_grid)
    step_fn = build_train_step(cfg, run, q_chunk=args.q_chunk, device=dev)
    if params is None:
        params = init_params(cfg, seed=run.seed, device=dev)
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
        if step % args.log_every == 0:
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
    return ap


def main(argv=None) -> None:
    out = train(build_parser().parse_args(argv))
    if out["losses"]:
        print(f"[train] done at step {out['final_step']}; "
              f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
