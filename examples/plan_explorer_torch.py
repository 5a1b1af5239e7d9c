"""Plan explorer of the PyTorch port: visualize how each CP strategy
shards a packed sequence.

ASCII rendering of worker assignments plus the balance/communication
numbers the paper's figures are built from.  Strategies resolve through
the :mod:`repro_torch.planner` registry — pass ``--strategy all`` to
sweep every registered planner, or a comma-separated subset.  Planning
runs on the host; like every entry point of the port, the explorer
starts only where a card is present unless given ``--device cpu``.

    PYTHONPATH=src python examples/plan_explorer_torch.py --dataset pile --cp 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.workload import comm_saving, comm_tokens_static
from repro_torch.data.distributions import make_rng
from repro_torch.data.packing import pack_sequence
from repro_torch.device import resolve_device
from repro_torch.planner import available_planners, get_planner

GLYPHS = "0123456789abcdef"


def render(plan, width=100):
    """One row per packed position range; glyph = worker id."""
    C = plan.context_len
    doc_starts = np.concatenate([[0], np.cumsum(plan.doc_lens)])[:-1]
    a = plan.arrays
    owner = np.zeros(C, np.int32)
    g = doc_starts[a.doc_id] + a.start
    for lo, ln, w in zip(g, a.length, a.worker):
        owner[lo:lo + ln] = w
    cells = np.array_split(owner, width)
    line = "".join(GLYPHS[int(np.bincount(c).argmax())] for c in cells)
    # document boundary markers
    marks = [" "] * width
    for d in doc_starts[1:]:
        marks[min(int(d * width / C), width - 1)] = "|"
    return "".join(marks) + "\n" + line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="pile",
                    choices=["wlb_llm", "pile", "redpajama"])
    ap.add_argument("--context", type=int, default=32768)
    ap.add_argument("--cp", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default="llama3,per_doc,flashcp",
                    help="comma-separated planner names, or 'all'")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)

    rng = make_rng(args.seed)
    lens = pack_sequence(args.dataset, args.context, rng)
    print(f"{args.dataset}: {len(lens)} documents in {args.context} tokens "
          f"(| marks document boundaries; digits are CP worker ids)\n")

    if args.strategy == "all":
        # skip the exponential reference solver on realistic mixes
        names = [n for n in available_planners()
                 if get_planner(n).info.cost_hint != "exponential"]
    else:
        names = args.strategy.split(",")

    for name in names:
        planner = get_planner(name)
        info = planner.info
        plan = planner(lens, args.cp)
        print(f"--- {name}  [comm={info.comm_style}, exec={info.exec_style}"
              f"{', order-preserving' if info.preserves_token_order else ''}]")
        print(render(plan))
        static = comm_tokens_static(args.context, args.cp)
        print(f"    imbalance {plan.imbalance_ratio():.3f} | "
              f"shards {len(plan.arrays)} | "
              f"comm {plan.comm_tokens()}/{static} tokens/rank "
              f"({comm_saving(plan):.0%} saved)\n")


if __name__ == "__main__":
    main()
