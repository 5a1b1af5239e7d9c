#!/usr/bin/env python
"""Standalone config autotuner CLI of the port (DESIGN.md §Autotune; the
twin of ``scripts/autotune.py``).

Searches the run-config knob space (``cp_strategy``, ``cp_overlap``,
``kernel_grid``, ``dispatch`` + target, ``kv_comm_dtype``) for one
(arch, mesh, length-profile) triple with the two-stage
predict-prune-measure search of :mod:`repro_torch.autotune` against the
H100's cost constants, prints the measured frontier as a ranked table,
and optionally writes the tuned :class:`repro_torch.configs.RunConfig`
as JSON.

The same search backs ``python -m repro_torch.launch.train
--autotune``; this entry point tunes ahead of time (and warms the
shared ``--cache-dir``) without constructing a training run.

    PYTHONPATH=src python scripts/autotune_torch.py --arch starcoder2_3b \\
        --smoke --mesh 1x2 --seq-len 512 --batch 2 \\
        --cache-dir tune_cache --out tuned.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="size-reduced arch config (CPU-scale dims)")
    ap.add_argument("--mesh", default="1x1", help="DxM")
    ap.add_argument("--attention-impl", default="flash",
                    choices=["flash", "plain"])
    ap.add_argument("--dataset", default="wlb_llm")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=8,
                    help="measured-trial frontier size")
    ap.add_argument("--cache-dir", default="",
                    help="content-addressed result cache ('' = off)")
    ap.add_argument("--out", default="",
                    help="write the tuned RunConfig JSON here")
    args = ap.parse_args(argv)

    from repro_torch.autotune import autotune_run
    from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
    from repro_torch.launch.train import parse_mesh

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    data, model = parse_mesh(args.mesh)
    run = RunConfig(arch=args.arch, attention_impl=args.attention_impl,
                    seed=args.seed)
    tuned_run, result = autotune_run(
        run, cfg, data=data, model=model, context_len=args.seq_len,
        seqs=args.batch, dataset=args.dataset, cache_dir=args.cache_dir,
        top_k=args.top_k)

    src = "cache hit" if result.cached else \
        f"searched {result.n_candidates} candidates"
    print(f"[autotune] {src} (key {result.key})")
    hdr = (f"{'rank':>4} {'strategy':12} {'overlap':8} {'grid':5} "
           f"{'dispatch':9} {'target':>6} {'dtype':7} "
           f"{'pred_us':>9} {'meas_us':>9} {'deg':>3}")
    print(hdr)
    print("-" * len(hdr))
    ranked = sorted(result.frontier,
                    key=lambda f: f["measured"]["step_s"])
    for rank, f in enumerate(ranked, 1):
        c = f["candidate"]
        print(f"{rank:>4} {c['cp_strategy']:12} {c['cp_overlap']:8} "
              f"{c['kernel_grid']:5} {c['dispatch']:9} "
              f"{c['dispatch_target_imbalance']:>6.2f} "
              f"{c['kv_comm_dtype']:7} "
              f"{f['predicted']['step_s'] * 1e6:>9.2f} "
              f"{f['measured']['step_s'] * 1e6:>9.2f} "
              f"{f['measured']['cp_degree']:>3}")
    print(f"[autotune] frontier predicted-vs-measured spearman "
          f"{result.spearman_frontier:.3f}")
    b = result.best
    print(f"[autotune] best: {b.cp_strategy}/{b.cp_overlap}/"
          f"{b.kernel_grid}/{b.dispatch}/{b.kv_comm_dtype} "
          f"({result.best_measured['step_s'] * 1e6:.2f}us modeled)")

    if args.out:
        payload = {"tuned": dataclasses.asdict(tuned_run),
                   "key": result.key,
                   "best_measured": result.best_measured,
                   "spearman_frontier": result.spearman_frontier}
        Path(args.out).write_text(json.dumps(payload, indent=1,
                                             sort_keys=True))
        print(f"[autotune] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
