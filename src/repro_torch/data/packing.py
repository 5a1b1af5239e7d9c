"""Input packing (paper §2.1): concatenate documents into one context window
(the port's own copy of ``repro.data.packing``).

Documents are drawn from a length distribution until the window is full; the
last document is truncated to fit (paper §4.1: "If the total length of the
input documents exceeds the context window size, the last document is
truncated to fit within the limit").
"""

from __future__ import annotations

import numpy as np

from .distributions import sample_doc_length

__all__ = ["pack_sequence", "sample_doc_pool", "doc_ids_and_positions"]


def pack_sequence(
    dataset: str,
    context_len: int,
    rng: np.random.Generator,
    *,
    min_doc_len: int = 16,
) -> np.ndarray:
    """Return an int64 array of document lengths summing exactly to
    ``context_len``."""
    lens: list[int] = []
    total = 0
    while total < context_len:
        d = sample_doc_length(dataset, rng)
        d = min(d, context_len - total)
        if d < min_doc_len and total + d < context_len:
            # merge ultra-short scraps into the previous document rather
            # than emitting degenerate docs (packing implementations do the
            # same to avoid 1-token documents).
            if lens:
                lens[-1] += d
            else:
                lens.append(d)
        else:
            lens.append(d)
        total += d
    out = np.asarray(lens, dtype=np.int64)
    assert out.sum() == context_len
    return out


def sample_doc_pool(
    dataset: str,
    budget_tokens: int,
    rng: np.random.Generator,
    *,
    max_doc_len: int | None = None,
    min_doc_len: int = 16,
    min_docs: int = 0,
) -> np.ndarray:
    """Sample one global step's document pool for the dispatcher.

    Unlike :func:`pack_sequence` (which fills a single window and
    truncates at the boundary), the pool keeps documents whole: sampling
    stops *before* the budget would be exceeded, so the dispatcher's
    bin packer — not the sampler — decides window placement, and the
    only truncation is the §Dispatch quantum trim.  Documents longer
    than ``max_doc_len`` (one window, typically) are clipped to it, since
    no bin could hold them whole; ultra-short scraps merge into the
    previous document exactly as the per-rank packer does.

    ``min_docs``: when the stop-before-exceed rule would end the pool
    with fewer documents (window-sized docs on a small budget), the
    overflowing document is truncated to the remaining budget instead —
    the same boundary truncation the per-rank packer applies — so every
    dispatcher bin can receive at least one document.
    """
    lens: list[int] = []
    total = 0
    while total < budget_tokens:
        d = sample_doc_length(dataset, rng)
        if max_doc_len is not None:
            d = min(d, max_doc_len)
        if total + d > budget_tokens:
            if len(lens) >= min_docs:
                break
            d = budget_tokens - total
            if d < min_doc_len:
                break
        if d < min_doc_len and lens:
            lens[-1] += d
        else:
            lens.append(d)
        total += d
    return np.asarray(lens, dtype=np.int64)


def doc_ids_and_positions(doc_lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-token document ids and intra-document positions for one packed
    sequence — the host-side ingredients of the document mask."""
    doc_ids = np.repeat(np.arange(len(doc_lens), dtype=np.int32), doc_lens)
    positions = np.concatenate([np.arange(d, dtype=np.int32) for d in doc_lens])
    return doc_ids, positions
