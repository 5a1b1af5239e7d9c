"""The runner of one-card cells: the whole run in this process, on card
0 (``run.run_cell``)."""

import torch

from cpbench.run import run_cell


def run(cell, seed: int, seconds: float, trace: bool,
        t_start: float) -> dict:
    return run_cell(cell, seed, seconds, trace,
                    device=torch.device("cuda", 0), t_start=t_start)
