"""The caching allocator's synchronising retries (a failed allocation,
the cache freed, ``cudaFree`` waiting for the device) a window step: the
port's ``alloc_retries`` counter (``repro_torch.obs``, the step span's
delta of ``num_alloc_retries``), the mean over the traced window's
steps, 0 where none ran."""

from cpbench.spans import recorded, window_steps


def read(run):
    s = recorded()
    if s is None or not run.steps or "alloc_retries" not in s["counters"]:
        return None
    by = s["counters"]["alloc_retries"]
    steps = window_steps(run)
    return sum(by.get(k, 0) for k in steps) / len(steps)
