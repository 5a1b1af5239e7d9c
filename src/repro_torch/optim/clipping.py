"""Global-norm gradient clipping (in place)."""

from __future__ import annotations

import torch

from ._slices import leaves, slices

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, accumulated in f32."""
    total = None
    for g in leaves(tree):
        for (s,) in slices(g):
            sq = torch.sum(s.float() ** 2)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / norm) in place; returns
    (grads, norm before clipping).  A bf16 gradient is scaled in f32 and
    rounded once, as ``(g.f32 * scale).astype(bf16)`` is."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, norm
