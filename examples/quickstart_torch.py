"""Quickstart of the PyTorch port: FlashCP in five minutes, on the card.

1. Pack documents into a context window and run Algorithm 1 — inspect the
   sharding plan against the baselines (balance + communication), on the
   host.
2. Train a tiny decoder for a few steps through the port's training path
   (planner -> plan encoding -> the doc-attention kernels -> AdamW).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
(``--device cpu`` runs the kernels' plain twins; without a card and
without it, the example refuses to start.)
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.workload import comm_saving
from repro_torch.data.distributions import make_rng
from repro_torch.data.packing import pack_sequence
from repro_torch.device import resolve_device
from repro_torch.planner import flashcp_plan, get_planner

#: where the tiny training writes its final checkpoint
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_quickstart_ckpt")
#: the tiny training's steps
TINY_STEPS = 10


def show_plans():
    print("=" * 70)
    print("FlashCP sharding plans: 128K context, 8 CP workers, WLB-LLM mix")
    print("=" * 70)
    rng = make_rng(0)
    lens = pack_sequence("wlb_llm", 131072, rng)
    print(f"packed {len(lens)} documents "
          f"(min {lens.min()}, median {int(np.median(lens))}, "
          f"max {lens.max()} tokens)\n")

    plan, stats = flashcp_plan(lens, 8)
    print("FlashCP (Algorithm 1):")
    print(plan.describe())
    print(f"  comm saving     : {comm_saving(plan):.1%} of the full "
          f"exchange (Eq.4 -> Eq.5)")
    print(f"  whole docs      : {stats.whole_docs}/{len(lens)} "
          f"(zero communication for these)\n")

    for name in ("llama3", "per_doc"):
        p = get_planner(name)(lens, 8)
        print(f"{name} baseline: imbalance {p.imbalance_ratio():.3f}, "
              f"{len(p.shards)} shards, comm {p.comm_tokens()} tokens/rank")
    print()


def tiny_training(device: str) -> dict:
    print("=" * 70)
    print(f"Tiny end-to-end training (reduced starcoder2_3b, {device})")
    print("=" * 70)
    from repro_torch.launch.train import build_parser, train

    args = build_parser().parse_args([
        "--arch", "starcoder2_3b", "--smoke", "--mesh", "1x1",
        "--strategy", "flashcp", "--attention-impl", "flash",
        "--dataset", "wlb_llm", "--seq-len", "256", "--batch", "2",
        "--steps", str(TINY_STEPS), "--lr", "1e-3", "--q-chunk", "128",
        "--grad-compression", "none", "--checkpoint-dir", CKPT_DIR,
        "--ckpt-every", "0", "--log-every", "2", "--device", device])
    out = train(args)
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"over {len(out['losses'])} steps")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default: the kernels) or cpu (their "
                         "plain twins)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    show_plans()
    return tiny_training(args.device)


if __name__ == "__main__":
    main()
