"""Device ms a step in operations that are neither matrix products, doc
attention nor NCCL: elementwise kernels, reductions, copies and fills,
attributed by their launch sites (``trace.py``)."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    devs = max(len(run.trace.devices()), 1)
    return 1e3 * run.trace.kind_s("other") / devs / len(run.steps)
