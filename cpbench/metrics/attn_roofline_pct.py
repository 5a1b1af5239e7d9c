"""The doc-attention kernels' share of their roofline: the least time
the step's attention needs, the larger of its FLOPs (``flops.py``, from
the rows' document lengths) over the published bf16 peak and its bytes
(q, k, v, o, dO, dQ, dK, dV and the lse, each once) over the published
HBM bandwidth, over the device time of the operations launched under
the port's doc-attention entry points (the rematerialized forward
included: it is work the step does again)."""

import numpy as np

from cpbench.flops import attention_bytes, attention_flops


def read(run):
    if run.trace is None or not run.steps or run.peaks is None:
        return None
    spec = run.cell.spec
    busy = run.trace.kind_s("attn")
    if busy <= 0:
        return None
    least = 0.0
    for s in run.steps:
        for lens in s["doc_lens"]:
            least += max(attention_flops(spec, lens)
                         / run.peaks["bf16_flops_per_s"],
                         attention_bytes(spec, int(np.sum(lens)))
                         / run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / busy
