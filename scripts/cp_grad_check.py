#!/usr/bin/env python3
"""Step-0 gradients of the CP training step against one rank, leaf by
leaf, on one NVIDIA GPU.

Full-width starcoder2_3b cut to ``chip_smoke.CP_TRAIN_LAYERS`` layers, on
step 0 of the ``chip_smoke.CP_SEQ``-token wlb_llm stream (flashcp, the
CUDA kernels): loss and gradients on one rank and over
``chip_smoke.CP_TRAIN_WORLD`` ranks (a ``1xN`` mesh, ZeRO-3), in two
variants:

* ``bf16``: the training dtype, the ranks' gradients summed in bf16 (the
  reduce-scatters of the parameter gathers);
* ``f32``: f32 parameters (the bf16 ones, widened) and f32 attention.

Per variant it prints the loss and global grad-norm differences, the
whole gradient's relative error ||g_N - g_1|| / ||g_1||, the leaves (per
layer) with the largest relative error and those that move the norm
most; then the bf16 gradients of one rank and of N ranks against the
f32 gradients of one rank.  One JSON line per comparison.

    python3 scripts/cp_grad_check.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)

VARIANTS = {"bf16": "bfloat16", "f32": "float32"}
TOP = 6


def grad_rank(rank, world, backend, store, res_dir, out_dir):
    """One CP rank: every variant's step-0 losses (to ``res_dir``) and
    whole gradients (rank 0 saves them to ``out_dir``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.ranks import init_rank

    _, dev = init_rank(rank, world, backend, store, "cuda")
    try:
        mesh = make_local_mesh(1, world, device_type="cuda")
        losses = {}
        for name, dtype in VARIANTS.items():
            loss, grads = cs.step0_grads(dtype, mesh, dev, backend)
            losses[name] = loss
            if rank == 0:
                torch.save(grads, Path(out_dir) / f"{name}.pt")
            del grads
            torch.cuda.empty_cache()
        with open(Path(res_dir) / f"rank{rank}.json", "w") as f:
            json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def compare(got: dict, want: dict) -> dict:
    """``chip_smoke.compare_grads`` with its leaves cut to the ``TOP``
    largest errors and the ``TOP`` largest norm movers."""
    out = cs.compare_grads(got, want)
    rows = out.pop("leaves")
    out["worst_leaves"] = rows[:TOP]
    out["norm_movers"] = sorted(
        rows, key=lambda r: -abs(r["norm_sq_gap"]))[:TOP]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cp_grad_check: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    _build.doc_attention_lib()
    one = {}
    for dtype in ("bfloat16", "float32"):
        one[dtype] = cs.step0_grads(dtype)
        torch.cuda.empty_cache()
    world = cs.CP_TRAIN_WORLD
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "grads"
        out.mkdir()
        ranks = cs.run_ranks(torch, grad_rank, world, str(out))
        for name, dtype in VARIANTS.items():
            loss_1, g1 = one[dtype]
            loss_n = ranks[0][name]
            gn = torch.load(out / f"{name}.pt")
            cs.emit("cp_grad_check", variant=name, world=world,
                    backend=cs.cp_backend(torch, world), dtype=dtype,
                    loss_1=loss_1, loss_n=loss_n,
                    loss_rel_diff=abs(loss_n - loss_1) / abs(loss_1),
                    n_vs_1=compare(gn, g1))
            if dtype == "bfloat16":
                cs.emit("cp_grad_check", variant=name,
                        against="f32 one rank",
                        one_rank_vs_f32=compare(one[dtype][1],
                                                one["float32"][1]),
                        n_ranks_vs_f32=compare(gn, one["float32"][1]))
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        cs.close_rank_pool()
    sys.exit(code)
