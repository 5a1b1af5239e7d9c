#!/usr/bin/env python
"""Modeled exposed communication of the port's flashcp CP island, chunked
against monolithic (the port's counterpart of the schedule half of
``benchmarks/bench_overlap.py``).

Traces one rank's island forward at N = 4 on the ``meta`` device (6
documents, 8192 tokens; 4 query and 2 KV heads of 64; the plain
attention, q chunks of 512) inside
:class:`repro_torch.launch.schedule.ScheduleTrace`, over its recording
communicator, and prints :func:`~repro_torch.launch.schedule.
schedule_model`'s ``ScheduleCost`` of both forms, at the reference's
default rates and at the H100's (``autotune.cost_model.HW``).  Every
number is a model's output, not a measurement; nothing runs on a card.

    PYTHONPATH=src python scripts/schedule_island_torch.py
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

N_CP = 4
DOC_LENS = [2500, 900, 1800, 1400, 700, 892]    # 8192 tokens
HQ, HKV, D = 4, 2, 64


def trace_island(overlap: str, *, rank: int = 0):
    """One rank's flashcp island forward, traced: the
    :class:`ScheduleTrace` (its ``comm`` holds the bytes counted)."""
    import numpy as np
    import torch

    from repro_torch.core.cp_attention import make_cp_context
    from repro_torch.launch.schedule import ScheduleTrace
    from repro_torch.planner import encode_plan_batch, get_planner

    plan = get_planner("flashcp")(np.asarray(DOC_LENS, np.int64), N_CP)
    stack, _ = encode_plan_batch([plan], align=128)
    arrays = {k: torch.from_numpy(v).to("meta") for k, v in stack.items()}
    t_loc = stack["doc"].shape[1] // N_CP
    trace = ScheduleTrace(rank, N_CP)
    ctx = make_cp_context(arrays, strategy="flashcp", impl="plain",
                          head_dim=D, q_chunk=512, overlap=overlap,
                          comm=trace.comm)
    q = torch.empty(1, HQ, t_loc, D, device="meta")
    k = torch.empty(1, HKV, t_loc, D, device="meta")
    v = torch.empty(1, HKV, t_loc, D, device="meta")
    with trace:
        ctx.attn(q, k, v)
    return trace


def main() -> int:
    from repro_torch.autotune.cost_model import HW
    from repro_torch.launch.schedule import schedule_model

    out = {}
    for overlap in ("none", "chunked"):
        trace = trace_island(overlap)
        out[overlap] = {
            "wire_bytes_by_kind": {k: b for k, b in
                                   trace.comm.wire_bytes_by_kind.items()
                                   if b},
            "reference_rates": dataclasses.asdict(schedule_model(trace)),
            "h100_rates": dataclasses.asdict(schedule_model(trace, hw=HW)),
        }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
