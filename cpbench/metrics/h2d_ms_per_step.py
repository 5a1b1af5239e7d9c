"""Host ms a window step spends uploading its batch: the port's
``batch_to_device`` spans (``repro_torch.obs``; pageable copies block
the host), summed over the traced window, over its steps."""

from cpbench.spans import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "batch_to_device")
