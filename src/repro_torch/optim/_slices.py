"""Leaf iteration for in-place optimizer passes: nested dicts of tensors
walked in sorted-key order (the reference's tree-leaf order), large
leaves cut along their leading axis so one f32 temporary stays small."""

from __future__ import annotations

from typing import Iterator

import torch

#: elements per slice: one f32 temporary of a slice is at most 256 MiB
SLICE_ELEMS = 1 << 26


def leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def slices(*tensors: torch.Tensor) -> Iterator[tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped tensors, cut along dim 0 into pieces
    of at most ``SLICE_ELEMS`` elements (whole rows; a 0-d or small
    tensor is one piece)."""
    t = tensors[0]
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        yield tensors
        return
    per = max(1, SLICE_ELEMS // max(t.numel() // t.shape[0], 1))
    for i in range(0, t.shape[0], per):
        yield tuple(x[i:i + per] for x in tensors)
