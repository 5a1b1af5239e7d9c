"""Global-norm gradient clipping (in place)."""

from __future__ import annotations

import torch

from ._slices import leaves, slices

__all__ = ["sum_of_squares", "global_norm", "clip_by_global_norm"]


def sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """Σ g² of one tensor, accumulated in f32."""
    total = None
    for (s,) in slices(g):
        sq = torch.sum(s.float() ** 2)
        total = sq if total is None else total + sq
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, accumulated in f32."""
    return torch.sqrt(sum(sum_of_squares(g) for g in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float, *, norm=None):
    """Scale every gradient by min(1, max_norm / norm) in place; returns
    (grads, norm before clipping).  ``norm`` is the global norm when the
    caller computed it (over the shards of every rank); else it is this
    tree's.  A bf16 gradient is scaled in f32 and rounded once, as
    ``(g.f32 * scale).astype(bf16)`` is."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale)
    return grads, norm
