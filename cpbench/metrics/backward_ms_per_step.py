"""Device ms a window step spends in the port's backward, the
rematerialized forward included: between the entry and exit CUDA events
of its ``step.backward`` spans (``repro_torch.obs``), the mean over the
traced window's steps."""

from cpbench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "step.backward")
