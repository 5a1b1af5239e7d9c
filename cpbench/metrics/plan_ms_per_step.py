"""Host ms a window step's batch took in the port's planner (through its
plan cache), Eq. 5 encoding and visit-table emitter, on the prefetch
thread, by the harness's clock: the mean over the traced window's
steps.  Every step trains fresh rows, so the planner plans each one."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s["plan_s"] for s in run.steps) / len(run.steps)
