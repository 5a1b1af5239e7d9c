#!/usr/bin/env python3
"""The CP exchange's link rate over NCCL, one rank per card, on a host
with 4 NVIDIA GPUs: the cost model's ``ici_bw``
(``repro_torch.autotune.cost_model.HW``).

Each rank all-gathers a bf16 piece of each of PIECE_MIB sizes
(``all_gather_into_tensor``, as the CP islands' monolithic exchange) and
passes the same piece one hop round the ring (``batch_isend_irecv``, as
the chunked exchange): device time by CUDA events, median of REPS after
WARM.  A rank's send rate is the bytes it sends over that time: (N - 1)
pieces for the all-gather, one for the hop, the cost model's
``comm_bytes / ici_bw``.  Prints one JSON line per (collective, size),
the slowest rank's, and an ``ici_bw`` line: the all-gather's rate at the
largest piece.

    python3 scripts/nccl_allgather_bw.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
PIECE_MIB = (1, 4, 16, 64, 256)
WARM, REPS = 5, 20


def _median_ms(torch, fn) -> float:
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.ranks import init_rank

    _, dev = init_rank(rank, world, "nccl", store, "cuda")
    try:
        rows = []
        to, frm = (rank + 1) % world, (rank - 1) % world
        for mib in PIECE_MIB:
            n = mib * 2 ** 20 // 2
            piece = torch.randn(n, device=dev).bfloat16()
            full = torch.empty(n * world, dtype=piece.dtype, device=dev)
            recv = torch.empty_like(piece)

            def gather():
                dist.all_gather_into_tensor(full, piece)

            def hop():
                for w in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, piece, to),
                         dist.P2POp(dist.irecv, recv, frm)]):
                    w.wait()

            for name, fn, sent in (("all_gather", gather,
                                    (world - 1) * n * 2),
                                   ("hop", hop, n * 2)):
                ms = _median_ms(torch, fn)
                rows.append({"collective": name, "piece_bytes": n * 2,
                             "sent_bytes": sent, "ms": ms,
                             "bytes_per_s": sent / (ms * 1e-3)})
            del piece, full, recv
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    from repro_torch.launch.ranks import spawn_ranks

    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"nccl_allgather_bw: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        spawn_ranks(rank_main, WORLD, args=(WORLD, f"{tmp}/store", tmp),
                    timeout=600)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(WORLD)]
    for i, row in enumerate(ranks[0]):
        worst = max((r[i] for r in ranks), key=lambda x: x["ms"])
        print(json.dumps({"phase": "nccl_bw", "world": WORLD,
                          **{k: worst[k] for k in row}}), flush=True)
    big = [max((r[i] for r in ranks), key=lambda x: x["ms"])
           for i, row in enumerate(ranks[0])
           if row["collective"] == "all_gather"
           and row["piece_bytes"] == max(PIECE_MIB) * 2 ** 20]
    print(json.dumps({"phase": "ici_bw", "bytes_per_s":
                      big[0]["bytes_per_s"], "piece_bytes":
                      big[0]["piece_bytes"],
                      "cards": card.strip().splitlines()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
