"""Host ms a window step waited for its batch from the prefetch thread
(the port's planner, Eq. 5 encoding and visit tables), on the harness's
clock: the mean over the traced window's steps."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(s["wait_s"] for s in run.steps) / len(run.steps)
