"""Host ms a batch spends in the port's planner, Eq. 5 encoding and
visit-table emitter, by the port's own spans (``repro_torch.obs``:
``plan``, ``encode``, ``tables``, on the prefetch thread): their sum over
the traced window over the batches planned in it (its ``plan`` spans)."""

from cpbench.spans import recorded

PARTS = ("plan", "encode", "tables")


def read(run):
    s = recorded()
    if s is None:
        return None
    batches = sum(1 for r in s["records"] if r["name"] == "plan")
    if not batches:
        return None
    return sum(r["host_ms"] for r in s["records"]
               if r["name"] in PARTS) / batches
