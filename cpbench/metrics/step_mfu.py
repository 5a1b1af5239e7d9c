"""The whole step's share of the chip's bf16 peak over the traced
window: the window's model FLOPs (``flops.py``: 6 x the non-embedding
parameters a token plus the documents' attention) over the traced
window's seconds x the published peak x the chips."""

from cpbench.flops import window_flops


def read(run):
    if run.trace is None or not run.steps or run.peaks is None:
        return None
    return 100.0 * window_flops(run.cell.spec, run.steps) / (
        run.trace.window_s * run.peaks["bf16_flops_per_s"] * run.cell.chips)
