"""Partial-attention merge substrate (online LSE).

Attention against any KV subset yields a merge-ready partial
``(o, m, l)``: the unnormalized fp32 accumulator, the row max and the
row sum.  Partials over disjoint KV subsets merge by the usual flash
rescaling in any order; an empty subset is ``(0, -1e30, 0)``, the merge
identity (``exp(-1e30 - m)`` is 0, never NaN).  :func:`merge_partials_axis`
folds one partial per rank of a process group (the distributed
flash-decode merge).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .comm import CPComm, all_reduce_

__all__ = ["NEG", "merge_partials", "merge_partials_axis",
           "finalize_partial"]

NEG = -1e30


def _merge_step(acc, part):
    ao, am, al = acc
    o, m, l = part
    m_new = torch.maximum(am, m)
    c1 = torch.exp(am - m_new)
    c2 = torch.exp(m - m_new)
    return (ao * c1[..., None] + o * c2[..., None], m_new, al * c1 + l * c2)


def merge_partials(parts):
    """Fold a sequence of (o, m, l) partials into one."""
    acc = None
    for p in parts:
        acc = p if acc is None else _merge_step(acc, p)
    return acc


def merge_partials_axis(part, comm: CPComm | None):
    """The collective form of :func:`merge_partials` (the reference's
    ``merge_partials_axis`` over a mesh axis): every rank's ``(o, m, l)``
    folded into the one merged partial, the same on every rank.  The
    global row max is an all-reduce MAX; each rank rescales its partial
    by ``exp(m - m_g)`` and the accumulator and the row sum are summed
    over the ranks.  Not differentiable (decode only).  ``comm=None`` is
    one rank: the partial itself."""
    if comm is None:
        return part
    o, m, l = part
    m_g = m.detach().clone()
    all_reduce_([m_g], comm, op=dist.ReduceOp.MAX)
    c = torch.exp(m - m_g)
    o_g = (o * c[..., None]).detach()
    l_g = (l * c).detach()
    all_reduce_([o_g, l_g], comm)
    return o_g, m_g, l_g


def finalize_partial(part, dtype: torch.dtype) -> torch.Tensor:
    """Normalize a merged partial into the attention output (0 where no
    KV was visible)."""
    o, _, l = part
    l = l[..., None]
    out = torch.where(l > 0, o / torch.clamp(l, min=1e-30),
                      torch.zeros((), dtype=o.dtype, device=o.device))
    return out.to(dtype)
