"""Layer 2 — the wire-bytes audit (DESIGN.md §Static-analysis; the torch
counterpart of the budget half of the reference's
``repro.analysis.hlo_audit``).

The reference diffs the collectives of a lowered XLA program against the
plan's *analytic* communication budget.  A torch program has no lowered
text to read, so the port audits what its collectives actually sent:
every :class:`~repro_torch.core.comm.CPComm` counts the bytes it hands
to ``torch.distributed`` by collective kind
(``wire_bytes_by_kind``: ``"permute"`` for the ring hops,
``"all_gather"``, ``"reduce_scatter"``), the int32 doc/pos metadata
included, and the largest result of one call of each kind
(``wire_peak_by_kind``).  :func:`audit_wire` holds those counts against
:func:`kv_exchange_budget`: every kind the rank used must be one the
plan predicted, with exactly the predicted volume (within ``slack``), and
no single all-gather may re-gather a tensor the plan keeps sharded.

Rule ids: WIRE101–WIRE103 (the reference's HLO101–HLO103).  The
reference's regex rules over program text (f64, host transfers,
donation: HLO104–HLO106) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis.findings import Finding
from repro_torch.core.workload import comm_bytes

__all__ = ["CommBudget", "kv_exchange_budget", "island_budget",
           "audit_wire"]


@dataclasses.dataclass(frozen=True)
class CommBudget:
    """Analytic per-rank wire-byte budget, by collective kind.

    ``allowed`` maps a :class:`~repro_torch.core.comm.CPComm` collective
    kind (``"permute"``, ``"all_gather"``, ``"reduce_scatter"``) to the
    total wire bytes the plan predicts for it; a kind absent from the map
    is *forbidden* (WIRE101).  ``slack`` is the fractional tolerance on
    each total.  ``full_gather_bytes``: if set, any single all-gather
    whose result is at least this size trips WIRE103 even when
    all-gathers are budgeted — a tensor the plan meant to keep sharded
    gathered whole.
    """

    allowed: dict[str, float]
    slack: float = 0.01
    full_gather_bytes: float | None = None
    note: str = ""


def kv_exchange_budget(buf_len: int, num_workers: int, kv_heads: int,
                       head_dim: int, *, dtype_bytes: int = 2,
                       fwd_and_bwd: bool = False, overlap: str = "chunked",
                       batch: int = 1, layers: int = 1,
                       slack: float = 0.01,
                       extra: dict[str, float] | None = None) -> CommBudget:
    """The attention KV exchange's analytic budget (Eq.4/Eq.5 outer).

    ``buf_len`` is the *static* per-rank exchange size — the Eq.5 pow2
    bucket for flashcp (:attr:`PlanEncoding.buf_len`), ``C / N`` for the
    full-exchange baselines.  The ranks move exactly this (the paper's
    single continuous communication buffer), so the counted wire bytes
    must match :func:`repro_torch.core.workload.comm_bytes` on it to
    within ``slack`` — the chunked hop rotation (N-1 hops of one buffer)
    and the blocking all-gather ((N-1)/N of N buffers) both reduce to the
    same total.

    The plan metadata riding the exchange (int32 doc + pos per buffer
    slot) is budgeted alongside the K/V payload on the same kind.
    ``batch`` and ``layers`` scale the budget to per-rank sample count
    and attention-layer count; ``extra`` admits additional kinds (or
    bytes on a budgeted kind).
    """
    mult = batch * layers
    payload = mult * comm_bytes(buf_len, num_workers, kv_heads, head_dim,
                                dtype_bytes=dtype_bytes,
                                fwd_and_bwd=fwd_and_bwd)
    # doc + pos: two int32 streams with the same (buf, N-1) geometry —
    # comm_bytes' leading "K and V" factor 2 counts exactly the pair.
    # Only the chunked rotation moves them, exactly once per program
    # (forward only — the indices are not re-exchanged in the backward
    # pass); the blocking layout reads the host-replicated copies.
    meta = batch * comm_bytes(buf_len, num_workers, 1, 1, dtype_bytes=4,
                              fwd_and_bwd=False) \
        if overlap == "chunked" else 0
    kind = "permute" if overlap == "chunked" else "all_gather"
    allowed = {kind: float(payload + meta)}
    for k, v in (extra or {}).items():
        allowed[k] = allowed.get(k, 0.0) + v
    return CommBudget(allowed=allowed, slack=slack,
                      note=f"kv-exchange {kind} buf_len={buf_len}")


def island_budget(strategy: str, overlap: str, *, buf_len: int,
                  num_workers: int, kv_heads: int, head_dim: int,
                  dtype_bytes: int, batch: int = 1,
                  slack: float = 0.01) -> CommBudget:
    """The forward budget of one CP island of the port
    (:func:`repro_torch.core.cp_attention.make_cp_context`) for the
    execution ``strategy`` at the effective ``overlap``.

    Two layouts differ from the reference's: the ring islands always
    rotate by hops (the ``"chunked"`` kind, whatever ``overlap`` says),
    and the monolithic all-gather island of the full-exchange baselines
    gathers the doc/pos metadata beside K and V (the reference's reads
    host-replicated copies), so those bytes are admitted on
    ``"all_gather"``."""
    extra = None
    if strategy in ("ring", "ring_zigzag"):
        overlap = "chunked"
    elif overlap == "none" and strategy not in ("flashcp", "contiguous"):
        extra = {"all_gather": float(batch * comm_bytes(
            buf_len, num_workers, 1, 1, dtype_bytes=4, fwd_and_bwd=False))}
    return kv_exchange_budget(buf_len, num_workers, kv_heads, head_dim,
                              dtype_bytes=dtype_bytes, overlap=overlap,
                              batch=batch, slack=slack, extra=extra)


def audit_wire(counted: dict, budget: CommBudget, *, context: str = "wire",
               largest: dict | None = None) -> list[Finding]:
    """WIRE101/WIRE102/WIRE103 — one rank's counted bytes by collective
    kind (``counted``, as ``CPComm.wire_bytes_by_kind``) against the
    analytic ``budget``; ``largest`` (as ``CPComm.wire_peak_by_kind``)
    gives the largest single result of each kind, for WIRE103."""
    out: list[Finding] = []
    for kind in sorted(set(counted) | set(budget.allowed)):
        tot = float(counted.get(kind, 0))
        cap = budget.allowed.get(kind)
        if cap is None:
            if tot > 0:
                out.append(Finding(
                    "WIRE101", "error", context,
                    f"unpredicted collective kind `{kind}`: {tot:.6g} wire "
                    f"bytes the plan's comm budget does not account for",
                    hint="redundant KV communication or stray collective — "
                         "the plan predicted none of this kind (Eq.5)"))
            continue
        lo = cap * (1.0 - budget.slack)
        hi = cap * (1.0 + budget.slack)
        if tot > hi or (math.isfinite(cap) and tot < lo):
            out.append(Finding(
                "WIRE102", "error", context,
                f"`{kind}` moves {tot:.6g} wire bytes, analytic budget "
                f"{cap:.6g} (±{budget.slack:.0%} slack) "
                f"[{budget.note}]".rstrip(" []"),
                hint="the exchange differs from the plan's Eq.4/Eq.5 "
                     "volume — check the bucket size and the island's "
                     "payload"))
    if budget.full_gather_bytes is not None and largest:
        big = float(largest.get("all_gather", 0))
        if big >= budget.full_gather_bytes:
            out.append(Finding(
                "WIRE103", "error", context,
                f"full-size all-gather: {big:.6g} result bytes (threshold "
                f"{budget.full_gather_bytes:.6g})",
                hint="a tensor the plan keeps sharded was gathered whole"))
    return out
