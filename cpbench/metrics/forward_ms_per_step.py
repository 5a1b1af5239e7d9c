"""Device ms a window step spends in the port's forward: between the
entry and exit CUDA events of its ``step.forward`` spans
(``repro_torch.obs``; one a micro-batch), the mean over the traced
window's steps."""

from cpbench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "step.forward")
