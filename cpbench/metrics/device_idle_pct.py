"""The share of the traced window in which no operation ran on the
device: one minus the union of the device's operation intervals over
the window (the union, not the sum: NCCL overlaps compute on another
stream)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
