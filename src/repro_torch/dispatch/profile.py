"""Document-length profiling for CP group sizing (DESIGN.md §Dispatch).

A :class:`LengthProfile` summarizes one global step's document pool: the
quantiles and tail mass that decide whether the step is a "short-doc" mix
(tiny CP groups suffice — nearly every document is its own last shard, so
KV exchange is near-zero at any degree and smaller groups cut the
``(N-1)`` collective factor) or a "heavy-tail" mix (long documents must
spread over many ranks before per-device workload balances).

The profile is cheap (one sort over the pool) and is attached to the
emitted :class:`repro_torch.dispatch.dispatcher.DispatchPlan` for
logging; the degree *decision* itself is simulation-driven — see
:func:`repro_torch.dispatch.dispatcher.dispatch_step`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LengthProfile", "profile_lengths"]


@dataclasses.dataclass(frozen=True)
class LengthProfile:
    """Summary statistics of a document-length pool (tokens)."""

    n_docs: int
    total_tokens: int
    max_len: int
    p50: int
    p90: int
    p99: int
    #: fraction of pool *tokens* living in documents longer than the
    #: reference length passed to :func:`profile_lengths` (default: one
    #: static CP shard, C / N_model) — the mass that forces KV exchange.
    tail_token_frac: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def profile_lengths(doc_lens, *, tail_len: int = 0) -> LengthProfile:
    """Profile a pool of document lengths.

    ``tail_len``: documents strictly longer than this are counted into
    ``tail_token_frac`` (0 disables the tail split).
    """
    lens = np.asarray(doc_lens, dtype=np.int64)
    if lens.size == 0:
        return LengthProfile(0, 0, 0, 0, 0, 0, 0.0)
    total = int(lens.sum())
    tail = int(lens[lens > tail_len].sum()) if tail_len > 0 else 0
    p50, p90, p99 = (int(np.percentile(lens, q)) for q in (50, 90, 99))
    return LengthProfile(
        n_docs=int(lens.size),
        total_tokens=total,
        max_len=int(lens.max()),
        p50=p50, p90=p90, p99=p99,
        tail_token_frac=tail / total if total else 0.0,
    )
