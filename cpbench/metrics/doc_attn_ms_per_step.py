"""Device ms a window step in the doc-attention kernels, by the port's
own ranges: the operations of the trace whose launch site (the innermost
host range at the launch) is one of the port's ``doc_attention.*``
spans, around the CUDA launches of ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv`` (the rematerialized forward included)."""

SITE = "repro_torch.doc_attention."


def read(run):
    if run.trace is None or not run.steps:
        return None
    lo, hi = run.trace.window
    us = [min(o.end, hi) - max(o.start, lo) for o in run.trace.ops
          if o.site.startswith(SITE) and o.end > lo and o.start < hi]
    if not us:
        return None
    devs = max(len(run.trace.devices()), 1)
    return 1e-3 * sum(us) / devs / len(run.steps)
