"""The control and the planted faults of a cell, read at the cell's own
size (on the card; the benchmark's runs do not run this):

    python3 -m cpbench.control --workload sc2_3b_e32.train.wlb_llm \\
        --seeds 11 12 13

For each seed it trains the cell's first steps on the cell's rows with
the plain reference in float32, and puts in the port's place: the
control (the reference with float8 e4m3 matrix products, the precision
below the configuration's bf16) and the fault of half of every row's
labels left out, the mean taken over the rest.  It prints each one's
compared numbers (``check.readings``) against the float32 reference,
one JSON line a seed; a step that returns its state unchanged reads 1
on ``change_gap`` by construction and is not run.  With
``--program-seeds`` it first reads the port's own numbers on those
seeds, in this one process, each a run of the cell with a one-step
window (``run.run_cell``): the lower readings the limits are set from.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .check import readings
from .manifest import load_cell, load_reference
from .run import CHECK_STEPS, _reference, run_cell
from .traffic import Traffic

__all__ = ["control_readings", "program_readings", "main"]


def control_readings(cell, seed: int, device) -> dict:
    """{"control": readings, "half_batch": readings} of one seed."""
    spec = cell.spec
    module = load_reference(spec.reference)
    traffic = Traffic(cell.mix, spec.vocab, seed)
    rows = [traffic.rows(step) for step in range(CHECK_STEPS)]
    ref = _reference(module, spec, seed, device, rows)
    out = {}
    for name, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"drop_half": True})):
        side = _reference(module, spec, seed, device, rows, **kw)
        out[name] = readings(side, ref)
    return out


def program_readings(cell, seed: int, device) -> dict:
    """The port's compared numbers of one seed, and whether the cell's
    limits hold them."""
    r = run_cell(cell, seed, 0.0, False, device=device,
                 t_start=time.perf_counter())
    return {"correct": r["correct"], "setup_s": r["metrics"]["setup_s"]
            ["value"], **{k: c["value"] for k, c in r["checks"].items()},
            **r["readings"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.program_seeds:
        print(json.dumps({"workload": cell.name, "seed": seed, "program":
                          program_readings(cell, seed, args.device)}),
              flush=True)
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          **control_readings(cell, seed, args.device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
