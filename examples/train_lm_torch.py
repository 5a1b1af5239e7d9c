"""End-to-end driver of the PyTorch port: train a ~160M-parameter LM with
FlashCP packing, on the card.

The model (12L, d=768, 12H, vocab 50304 — GPT-2-small scale; 162M params
with untied head, f32) trains on packed multi-document sequences with
document-masked attention, through the port's training path (planner ->
plan encoding -> the doc-attention kernels -> AdamW -> checkpoints).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300

Checkpoints go every 100 steps to ``repro_torch_lm100m`` in the temp
directory (``$TMPDIR``, else ``/tmp``), and a second call resumes from
the latest one (``--steps 320`` continues a finished 300-step run).
``--attention-impl plain`` trains through the chunked dense attention
instead of the kernels; ``--device cpu`` runs on the CPU (the kernels'
plain twins).  Use --steps 20 for a quick look.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.configs as configs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

LM_100M = ModelConfig(
    name="lm_124m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50304,
    head_dim=64,
    mlp="gelu",
    dtype="float32",
)

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_lm100m")


def train_args(argv=None):
    """The port trainer's arguments for the example's flags."""
    from repro_torch.launch.train import build_parser

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--dataset", default="pile")
    ap.add_argument("--attention-impl", default="flash",
                    choices=("flash", "plain"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return build_parser().parse_args([
        "--arch", LM_100M.name, "--mesh", "1x1", "--strategy", "flashcp",
        "--attention-impl", args.attention_impl, "--dataset", args.dataset,
        "--seq-len", str(args.seq_len), "--batch", str(args.batch),
        "--steps", str(args.steps), "--lr", str(args.lr),
        "--q-chunk", "128", "--grad-compression", "none",
        "--checkpoint-dir", CKPT_DIR, "--ckpt-every", "100",
        "--log-every", "10", "--resume", "--prefetch",
        "--device", args.device])


def main(argv=None, params=None) -> dict:
    """Train; ``params`` (whole leaves on the device) replaces the seeded
    initialization, as in ``launch.train.train``."""
    args = train_args(argv)
    # register the example config and drive the standard trainer
    configs.ARCHS[LM_100M.name] = LM_100M
    print(f"training {LM_100M.name}: "
          f"{LM_100M.param_count()/1e6:.0f}M params, "
          f"seq {args.seq_len}, batch {args.batch}, {args.steps} steps")

    from repro_torch.launch.train import train
    out = train(args, params=params)
    print(f"done: loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
