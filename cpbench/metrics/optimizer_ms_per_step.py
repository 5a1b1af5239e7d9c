"""Device ms a window step spends in the port's update (clipping,
compression, the schedule, AdamW): between the entry and exit CUDA
events of its ``step.optimizer`` span (``repro_torch.obs``), the mean
over the traced window's steps."""

from cpbench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "step.optimizer")
