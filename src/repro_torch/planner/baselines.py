"""Baseline CP sharding plans (paper §4.1): Llama3 CP, Per-Doc CP, Ring-Attn.

All baselines are expressed as :class:`~repro_torch.planner.plan.ShardingPlan`s
over the *same* substrate as FlashCP so that the paper's comparisons
(Fig. 5/6/7) run on identical machinery; only the plan and the
communication style differ.

* ``llama3_plan``   — Per-Seq sharding: the packed sequence is split into
  2N equal chunks regardless of document boundaries (zigzag pairing i and
  2N-1-i, Fig. 1(b)); full-KV all-gather (Eq. 4).  Workload-imbalanced under
  document masking.
* ``per_doc_plan``  — every document is zigzag-split into 2N chunks
  (WLB-LLM); balanced but kernel-inefficient; full-KV all-gather (Eq. 4).
* ``ring_zigzag_plan`` — same shard layout as Per-Doc, but KV travels by
  P2P ring (``comm_style='ring'``).

All constructors are vectorized: a plan over thousands of shards is built
from a handful of numpy ops (segment intersection for the chunked schemes,
a (n_docs, 2N) size matrix for Per-Doc zigzag) — no per-shard Python loop.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .plan import ShardArrays, ShardingPlan, validate_plan
from .registry import register_planner

__all__ = ["llama3_plan", "per_doc_plan", "ring_zigzag_plan",
           "contiguous_plan"]


def _chunked_plan_arrays(doc_lens: np.ndarray, chunk_bounds: np.ndarray,
                         chunk_worker: np.ndarray) -> ShardArrays:
    """Shards produced by cutting the packed sequence at ``chunk_bounds``
    (monotone, covering [0, C]) and at every document boundary; segment k
    belongs to the chunk it falls in and to the document it falls in."""
    doc_bounds = np.concatenate([[0], np.cumsum(doc_lens)])
    cuts = np.unique(np.concatenate([doc_bounds, chunk_bounds]))
    seg_lo, seg_hi = cuts[:-1], cuts[1:]
    keep = seg_hi > seg_lo
    seg_lo, seg_hi = seg_lo[keep], seg_hi[keep]
    doc_id = np.searchsorted(doc_bounds, seg_lo, side="right") - 1
    chunk_id = np.searchsorted(chunk_bounds, seg_lo, side="right") - 1
    return ShardArrays(doc_id, seg_lo - doc_bounds[doc_id],
                       seg_hi - seg_lo, chunk_worker[chunk_id]).merged()


@register_planner(
    "llama3",
    description="Per-Seq 2N-chunk zigzag sharding (Llama3 CP); full-KV "
                "all-gather",
    comm_style="allgather", exec_style="allgather",
    order_invariant=False, cost_hint="vectorized", context_multiple=2)
def llama3_plan(doc_lens: Sequence[int], num_workers: int,
                *, validate: bool = True) -> ShardingPlan:
    """Per-Seq sharding: 2N uniform chunks of the packed sequence, worker i
    receives chunks i and 2N-1-i.  Document boundaries are ignored, so a
    chunk may contain pieces of several documents (each piece becomes a
    Shard of its own document)."""
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    ctx = int(doc_lens.sum())
    n2 = 2 * num_workers
    assert ctx % n2 == 0, f"context {ctx} must divide 2N={n2} for Llama3 CP"
    chunk = ctx // n2
    c = np.arange(n2)
    worker_of = np.where(c < num_workers, c, n2 - 1 - c)
    arrays = _chunked_plan_arrays(doc_lens, np.arange(n2 + 1) * chunk,
                                  worker_of)
    plan = ShardingPlan(doc_lens=doc_lens, arrays=arrays,
                        num_workers=num_workers, comm_style="allgather")
    if validate:
        validate_plan(plan)
    return plan


@register_planner(
    "per_doc",
    description="Per-Doc zigzag sharding (WLB-LLM); full-KV all-gather",
    comm_style="allgather", exec_style="allgather",
    needs_equal_tokens=False, order_invariant=True, cost_hint="vectorized")
def per_doc_plan(doc_lens: Sequence[int], num_workers: int,
                 *, validate: bool = True) -> ShardingPlan:
    """Per-Doc CP (WLB-LLM): zigzag-shard every document independently."""
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    n, n2 = len(doc_lens), 2 * num_workers
    base, rem = np.divmod(doc_lens, n2)                      # (n,)
    c = np.arange(n2)
    sizes = base[:, None] + (c[None, :] < rem[:, None])      # (n, 2N)
    starts = np.cumsum(sizes, axis=1) - sizes
    worker_of = np.where(c < num_workers, c, n2 - 1 - c)
    arrays = ShardArrays(
        np.repeat(np.arange(n), n2), starts.ravel(), sizes.ravel(),
        np.broadcast_to(worker_of, (n, n2)).ravel())
    keep = arrays.length > 0
    arrays = arrays._take(keep).merged()
    plan = ShardingPlan(doc_lens=doc_lens, arrays=arrays,
                        num_workers=num_workers, comm_style="allgather")
    if validate:
        # zigzag remainders can leave ±1-token differences between workers;
        # Per-Doc CP in practice pads documents — we only require coverage.
        validate_plan(plan, require_equal_tokens=False)
    return plan


@register_planner(
    "ring_zigzag", aliases=("ring",),
    description="Per-Doc zigzag layout with ring P2P KV exchange "
                "(Ring-Attn Zigzag)",
    comm_style="ring", exec_style="ring",
    needs_equal_tokens=False, order_invariant=True, cost_hint="vectorized")
def ring_zigzag_plan(doc_lens: Sequence[int], num_workers: int,
                     *, validate: bool = True) -> ShardingPlan:
    """Ring-Attn (Zigzag): Per-Doc layout with ring P2P communication."""
    plan = per_doc_plan(doc_lens, num_workers, validate=validate)
    plan.comm_style = "ring"
    return plan


@register_planner(
    "contiguous",
    description="Contiguous N-chunk sharding (order-preserving, for "
                "recurrent/hybrid archs) with sharding-aware comm",
    comm_style="flashcp", exec_style="contiguous",
    order_invariant=False, preserves_token_order=True,
    cost_hint="vectorized")
def contiguous_plan(doc_lens: Sequence[int], num_workers: int,
                    *, validate: bool = True) -> ShardingPlan:
    """Contiguous N-chunk sharding with FlashCP's sharding-aware comm.

    Used for recurrent architectures (Jamba's Mamba layers, xLSTM): SSM
    state must flow rank i -> i+1, so token order must be preserved across
    ranks.  FlashCP's communication mechanism still applies (documents
    wholly inside one chunk are never exchanged; only non-last doc pieces
    are), but Whole-Doc *placement* is constrained by the ordering —
    recorded in DESIGN.md §Arch-applicability.
    """
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    ctx = int(doc_lens.sum())
    assert ctx % num_workers == 0
    chunk = ctx // num_workers
    arrays = _chunked_plan_arrays(doc_lens,
                                  np.arange(num_workers + 1) * chunk,
                                  np.arange(num_workers))
    plan = ShardingPlan(doc_lens=doc_lens, arrays=arrays,
                        num_workers=num_workers, comm_style="flashcp")
    if validate:
        validate_plan(plan)
    return plan


@register_planner(
    "flashcp",
    description="FlashCP Algorithm 1: whole-doc LPT + equal-token repair "
                "+ per-doc zigzag fallback; sharding-aware comm (Eq. 5)",
    comm_style="flashcp", exec_style="flashcp",
    order_invariant=True, supports_target_ratio=True,
    cost_hint="vectorized")
def _flashcp_adapter(doc_lens, num_workers, *, validate=True,
                     target_ratio: float = 1.05):
    from .heuristic import flashcp_plan

    plan, _ = flashcp_plan(doc_lens, num_workers, validate=validate,
                           target_ratio=target_ratio)
    return plan
