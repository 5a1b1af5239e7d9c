"""Workload and communication accounting for CP sharding plans (paper
§3.1–3.2; the port's copy of the reference's ``repro.core.workload``).

The byte formulas follow the paper:

  Eq. 4 (static full-KV exchange, Llama3 CP / Per-Doc CP / Ring-Attn):
      bytes = 4 * (Σ d_i / N) * H * D * (N - 1) * dtype_bytes

  Eq. 5 (FlashCP sharding-aware exchange):
      bytes = 4 * (max_j Σ_{i∈Ŝ} x_ij s_i) * H * D * (N - 1) * dtype_bytes

The leading 4 covers K and V in both forward and backward.  ``H`` is the
number of **KV** heads (GQA communicates only KV heads) and ``D`` the head
dimension.  ``chip_smoke.py``'s ``cp_islands`` prints these figures beside
the bytes the islands hand to :class:`~repro_torch.core.comm.CPComm`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.planner.plan import ShardingPlan

__all__ = [
    "shard_workload",
    "causal_doc_workload",
    "total_workload",
    "comm_tokens_static",
    "comm_tokens_flashcp",
    "comm_bytes",
    "plan_comm_bytes",
    "comm_saving",
]


def shard_workload(prefix: int, length: int) -> float:
    """W_i = (2 p_i + s_i + 1) * s_i / 2."""
    return (2 * prefix + length + 1) * length / 2.0


def causal_doc_workload(doc_len: int) -> float:
    """Total attention workload of one whole document: (d+1) d / 2."""
    return shard_workload(0, doc_len)


def total_workload(doc_lens) -> float:
    return float(sum(causal_doc_workload(int(d)) for d in doc_lens))


def comm_tokens_static(context_len: int, num_workers: int) -> int:
    """Per-rank KV tokens moved by a full exchange (Eq. 4 inner term)."""
    return context_len // num_workers


def comm_tokens_flashcp(plan: ShardingPlan) -> int:
    """Eq. 5 inner term: max_j Σ_{i∈Ŝ} x_ij s_i."""
    return int(np.max(plan.nonlast_tokens_per_worker()))


def comm_bytes(
    comm_tokens: int,
    num_workers: int,
    kv_heads: int,
    head_dim: int,
    *,
    dtype_bytes: int = 2,
    fwd_and_bwd: bool = True,
) -> int:
    """Bytes on the critical path for the KV exchange (Eq. 4 / Eq. 5 outer)."""
    factor = 4 if fwd_and_bwd else 2  # K and V; x2 again for fwd+bwd
    return factor * comm_tokens * kv_heads * head_dim * (num_workers - 1) \
        * dtype_bytes


def plan_comm_bytes(
    plan: ShardingPlan,
    kv_heads: int,
    head_dim: int,
    *,
    dtype_bytes: int = 2,
    fwd_and_bwd: bool = True,
) -> int:
    """Critical-path KV-exchange bytes for a plan, honouring its comm style."""
    return comm_bytes(
        plan.comm_tokens(),
        plan.num_workers,
        kv_heads,
        head_dim,
        dtype_bytes=dtype_bytes,
        fwd_and_bwd=fwd_and_bwd,
    )


def comm_saving(plan: ShardingPlan) -> float:
    """Fraction of Eq. 4 traffic eliminated by sharding-aware comm (§4.3):
    the paper's "communication saving", 1 - Eq.5 / Eq.4."""
    static = comm_tokens_static(plan.context_len, plan.num_workers)
    if static == 0:
        return 0.0
    return 1.0 - plan.comm_tokens() / static
