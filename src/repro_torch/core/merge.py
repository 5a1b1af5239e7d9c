"""Partial-attention merge substrate (online LSE).

Attention against any KV subset yields a merge-ready partial
``(o, m, l)``: the unnormalized fp32 accumulator, the row max and the
row sum.  Partials over disjoint KV subsets merge by the usual flash
rescaling in any order; an empty subset is ``(0, -1e30, 0)``, the merge
identity (``exp(-1e30 - m)`` is 0, never NaN).
"""

from __future__ import annotations

import torch

__all__ = ["NEG", "merge_partials", "finalize_partial"]

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


def finalize_partial(part, dtype: torch.dtype) -> torch.Tensor:
    """Normalize a merged partial into the attention output (0 where no
    KV was visible)."""
    o, _, l = part
    l = l[..., None]
    out = torch.where(l > 0, o / torch.clamp(l, min=1e-30),
                      torch.zeros((), dtype=o.dtype, device=o.device))
    return out.to(dtype)
