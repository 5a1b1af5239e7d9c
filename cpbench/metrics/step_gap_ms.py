"""Device ms from one step's end to the next one's start: from the exit
CUDA event of the port's ``step`` span (``repro_torch.obs``) to the
entry event of the next step's, the mean over the traced window's
consecutive steps.  It holds the step's last host sync, the wait for the
next batch and its upload."""

from cpbench.spans import recorded, window_steps


def read(run):
    s = recorded()
    if s is None:
        return None
    steps = window_steps(run)
    by = {r["step"]: r for r in s["records"]
          if r["name"] == "step" and r["step"] in steps and "device_ms" in r}
    gaps = [by[k + 1]["device_start_ms"] - by[k]["device_end_ms"]
            for k in by if k + 1 in by]
    return sum(gaps) / len(gaps) if gaps else None
