"""Host ms of Python's garbage collections a window step, on any thread:
the port's ``gc`` spans (``repro_torch.obs``, a ``gc.callbacks`` hook),
summed over the traced window, over its steps; 0 where none ran."""

from cpbench.spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "gc", empty=0.0)
