"""Adaptive DP×CP token dispatcher (DESIGN.md §Dispatch).

The static execution model pins every batch to the full ``model`` mesh
axis: a batch of short documents pays CP-degree collectives it does not
need, and DP ranks sample documents independently with no cross-rank
balancing — one rank drawing a heavy-tail document taxes every rank,
because step time is the max over ranks.

The dispatcher replaces both decisions per global step:

1. **CP group sizing** — the ``data × model`` device grid is re-tiled
   into ``n_devices / cp`` CP subgroups of ``cp`` devices each
   (:func:`repro_torch.launch.mesh.make_group_mesh`), where ``cp`` adapts to
   the step's document-length profile.  Short-doc mixes run at CP 1/2
   (the whole-doc last-shard property makes KV exchange vanish and the
   ``(N-1)`` collective factor shrinks); heavy-tail mixes escalate to the
   full ``model`` axis so one long document spreads over enough ranks.
   Per-device token count is invariant across degrees: ``n_seqs * C /
   n_devices`` regardless of ``cp``.
2. **Cross-group token/workload dispatch** — the step's document pool is
   packed into per-sequence bins (capacity-LPT, :func:`pack_pool`) and
   bins are LPT-assigned to groups by attention workload
   (:func:`lpt_assign`), bounding both token and workload imbalance
   across *all* ``D × M`` devices, not just within one CP group.

Degree selection is simulation-driven: every admissible degree is packed
and assigned (host-side numpy, microseconds at batch scale), and the
smallest degree whose token *and* workload imbalance meet
``target_imbalance`` wins — smaller degrees strictly reduce collective
traffic, so feasibility is the only reason to escalate.  Ties and
infeasible profiles fall back to the most-balanced (then largest) degree.

This module is host-side only (numpy); the emitted
:class:`DispatchPlan` feeds the data pipeline
(:func:`repro_torch.data.pipeline.make_dispatch_batch`), which plans each
bin through the ordinary ``get_planner`` / ``encode_plan_batch`` /
``emit_visit_tables`` path at the chosen degree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .balance import (PackedPool, effective_imbalance, imbalance,
                      lpt_assign, pack_pool)
from .profile import LengthProfile, profile_lengths

__all__ = ["DispatchConfig", "DispatchPlan", "cp_degree_options",
           "dispatch_step", "estimate_comm_tokens"]


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Static dispatcher parameters (one per training run).

    ``data`` / ``model`` are the base mesh axis sizes; ``seqs`` the
    number of packed sequences per *global* step (the batch axis of the
    emitted arrays, sharded over the group axis of the re-tiled mesh).
    """

    data: int = 1
    model: int = 1
    seqs: int = 1
    target_imbalance: float = 1.1
    min_cp: int = 1
    max_cp: int = 0          # 0 -> model axis size
    fixed_cp: int = 0        # >0 pins the degree (adaptivity off)
    #: per-worker slice alignment: a degree is admissible only if
    #: ``(C / cp) % quantum == 0``.  Pass the pipeline's kernel block
    #: alignment (the visit tables need block-divisible rank slices);
    #: 0/1 = no alignment constraint.  Admissibility only — bin fills
    #: are never trimmed to it.
    quantum: int = 0
    #: bin-fill divisibility floor: bin totals are trimmed to a multiple
    #: of ``lcm(cp, bin_quantum)`` (default: ``cp`` alone — the
    #: planner's Eq. 2 requirement).  Set it to an lcm of degrees under
    #: comparison to make packing degree-invariant (parity harnesses).
    bin_quantum: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass
class DispatchPlan:
    """One global step's dispatch decision (host-side).

    Rows are ordered by group: rows ``[g * seqs_per_group, (g + 1) *
    seqs_per_group)`` belong to CP subgroup ``g`` — exactly the contiguous
    batch rows each group's ranks take on the re-tiled mesh's group
    axis.
    """

    cp_degree: int
    n_groups: int
    seqs_per_group: int
    rows: list[np.ndarray]          # per-row doc lengths, group-major
    row_docs: list[np.ndarray]      # pool indices backing each row
    group_of_row: np.ndarray        # (n_seqs,) int64
    group_tokens: np.ndarray        # (n_groups,) int64 valid tokens
    group_workload: np.ndarray      # (n_groups,) float64
    token_imbalance: float
    work_imbalance: float
    truncated_tokens: int
    est_comm_tokens: int
    profile: LengthProfile
    candidates: list[dict]          # per-degree evaluation summaries
    #: per-group speed factors the plan balanced against (None = uniform).
    #: When set, ``token_imbalance``/``work_imbalance`` are *effective*
    #: (speed-normalized completion-time) imbalances — the step-time
    #: quantity — and the raw load ratios live in the stats dict.
    group_speeds: np.ndarray | None = None

    def stats(self) -> dict:
        out = {
            "cp_degree": self.cp_degree,
            "n_groups": self.n_groups,
            "token_imbalance": self.token_imbalance,
            "work_imbalance": self.work_imbalance,
            "truncated_tokens": self.truncated_tokens,
            "est_comm_tokens": self.est_comm_tokens,
            "group_tokens": self.group_tokens.tolist(),
        }
        if self.group_speeds is not None:
            out["group_speeds"] = [float(s) for s in self.group_speeds]
            out["work_imbalance_raw"] = imbalance(self.group_workload)
            out["token_imbalance_raw"] = imbalance(self.group_tokens)
        return out


def cp_degree_options(cfg: DispatchConfig, context_len: int,
                      *, strict: bool = True) -> list[int]:
    """Admissible CP degrees, ascending.

    A degree ``g`` is admissible iff the mesh re-tiles cleanly and the
    batch splits evenly over the groups:

    * ``g`` divides the ``model`` axis (subgroups split the CP axis, never
      a data row);
    * ``seqs`` divides evenly over the ``n_devices / g`` groups (the batch
      axis shards the group axis without remainder);
    * ``context_len`` divides by ``g`` (Eq. 2's equal-token layout) *and*
      the per-worker slice ``C / g`` divides by the configured quantum —
      with the kernels' block size as the quantum this is exactly the
      "block-divisible rank slices" requirement of the visit tables.

    ``strict=False`` returns ``[]`` instead of raising when no degree (or
    a pinned ``fixed_cp``) is admissible — the autotuner probes whole
    config spaces and treats an empty list as "candidate inadmissible"
    (DESIGN.md §Autotune).
    """
    hi = cfg.max_cp or cfg.model
    q = max(cfg.quantum, 1)
    opts = []
    for g in range(1, cfg.model + 1):
        if cfg.model % g or g < cfg.min_cp or g > hi:
            continue
        n_groups = cfg.n_devices // g
        if cfg.seqs % n_groups:
            continue
        if context_len % g or (context_len // g) % q:
            continue
        if context_len % _bin_quantum(cfg, g):
            continue
        opts.append(g)
    if cfg.fixed_cp:
        if cfg.fixed_cp not in opts:
            if not strict:
                return []
            raise ValueError(
                f"fixed_cp={cfg.fixed_cp} inadmissible for mesh "
                f"{cfg.data}x{cfg.model}, seqs={cfg.seqs}, "
                f"C={context_len} (admissible: {opts})")
        return [cfg.fixed_cp]
    if not opts and strict:
        raise ValueError(
            f"no admissible CP degree for mesh {cfg.data}x{cfg.model}, "
            f"seqs={cfg.seqs}, C={context_len}")
    return opts


def _bin_quantum(cfg: DispatchConfig, g: int) -> int:
    return int(np.lcm(g, max(cfg.bin_quantum, 1)))


def estimate_comm_tokens(doc_lens, cp: int, context_len: int) -> int:
    """Cheap Eq. 5 proxy for one sequence at degree ``cp``.

    Tokens of each document beyond one worker's equal-token share must sit
    on other workers as non-last shards, so they are the floor of what the
    sharding-aware exchange moves.  Used only for candidate tie-breaking
    and logging — benchmarks recompute exact volumes from real plans.
    """
    if cp <= 1:
        return 0
    t_loc = context_len // cp
    lens = np.asarray(doc_lens, dtype=np.int64)
    return int(np.maximum(lens - t_loc, 0).sum())


def _group_speeds(device_speeds, n_groups: int, g: int) -> np.ndarray | None:
    """Per-group speed at degree ``g``: the slowest member bounds its
    group's CP step (groups are contiguous device slices)."""
    if device_speeds is None:
        return None
    ds = np.asarray(device_speeds, dtype=np.float64)
    assert ds.shape == (n_groups * g,) and (ds > 0).all(), ds
    gs = ds.reshape(n_groups, g).min(axis=1)
    gs = gs / gs.max()
    return None if np.allclose(gs, 1.0) else gs


def _evaluate(cfg: DispatchConfig, pool: np.ndarray, context_len: int,
              g: int, device_speeds=None) -> dict:
    n_groups = cfg.n_devices // g
    per_group = cfg.seqs // n_groups
    speeds = _group_speeds(device_speeds, n_groups, g)
    targets = None
    if speeds is not None:
        # capacity-proportional bin shaping: per_group bins per group
        # with fill targets ∝ group speed (quantum-floored) — the light
        # bins the speed-aware LPT routes onto slow groups.
        q = _bin_quantum(cfg, g)
        f = (np.floor(context_len * speeds / q) * q).astype(np.int64)
        targets = np.repeat(np.maximum(f, q), per_group)
    packed = pack_pool(pool, cfg.seqs, context_len,
                       quantum=_bin_quantum(cfg, g), targets=targets)
    tokens = packed.bin_tokens
    work = packed.bin_workloads
    assign = lpt_assign(work, n_groups, per_group=per_group, speeds=speeds)
    g_tok = np.bincount(assign, weights=tokens,
                        minlength=n_groups).astype(np.int64)
    g_work = np.bincount(assign, weights=work, minlength=n_groups)
    comm = sum(estimate_comm_tokens(b, g, context_len) for b in packed.bins)
    return {
        "cp_degree": g,
        "n_groups": n_groups,
        "seqs_per_group": per_group,
        "packed": packed,
        "assign": assign,
        "group_tokens": g_tok,
        "group_workload": g_work,
        "group_speeds": speeds,
        "token_imbalance": effective_imbalance(g_tok, speeds),
        "work_imbalance": effective_imbalance(g_work, speeds),
        "est_comm_tokens": int(comm),
    }


def dispatch_step(doc_pool, cfg: DispatchConfig, context_len: int,
                  device_speeds=None) -> DispatchPlan:
    """Size the CP groups and dispatch one step's document pool.

    Evaluates every admissible degree (ascending) by actually packing and
    LPT-assigning the pool, then picks the smallest degree whose token and
    workload imbalance both meet ``cfg.target_imbalance`` — smaller
    degrees never move more KV, so feasibility alone decides escalation.
    If no degree meets the target, the most-balanced (workload, then
    larger-degree) candidate wins.

    ``device_speeds``: optional per-device speed factors (flat device
    order, length ``cfg.n_devices``) from the straggler monitor
    (DESIGN.md §Recovery).  Candidates are then packed with
    speed-proportional bin targets, assigned by capacity-proportional
    LPT, and judged on *effective* (speed-normalized completion-time)
    imbalance — slow survivors get lighter bins instead of bounding
    every step.
    """
    pool = np.asarray(doc_pool, dtype=np.int64)
    opts = cp_degree_options(cfg, context_len)
    cands = [_evaluate(cfg, pool, context_len, g, device_speeds)
             for g in opts]

    chosen = None
    for c in cands:
        if c["token_imbalance"] <= cfg.target_imbalance and \
                c["work_imbalance"] <= cfg.target_imbalance:
            chosen = c
            break
    if chosen is None:
        chosen = min(cands,
                     key=lambda c: (c["work_imbalance"], -c["cp_degree"]))

    packed: PackedPool = chosen["packed"]
    assign = chosen["assign"]
    order = np.lexsort((np.arange(cfg.seqs), assign))   # group-major rows
    prof = profile_lengths(
        pool, tail_len=context_len // cfg.model if cfg.model > 1 else 0)

    def summary(c):
        return {k: v for k, v in c.items()
                if k not in ("packed", "assign", "group_tokens",
                             "group_workload", "group_speeds")} | {
            "token_imbalance": float(c["token_imbalance"]),
            "work_imbalance": float(c["work_imbalance"])}

    return DispatchPlan(
        cp_degree=chosen["cp_degree"],
        n_groups=chosen["n_groups"],
        seqs_per_group=chosen["seqs_per_group"],
        rows=[packed.bins[i] for i in order],
        row_docs=[packed.bin_docs[i] for i in order],
        group_of_row=assign[order],
        group_tokens=chosen["group_tokens"],
        group_workload=chosen["group_workload"],
        token_imbalance=float(chosen["token_imbalance"]),
        work_imbalance=float(chosen["work_imbalance"]),
        truncated_tokens=packed.truncated_tokens,
        est_comm_tokens=chosen["est_comm_tokens"],
        profile=prof,
        candidates=[summary(c) for c in cands],
        group_speeds=chosen["group_speeds"],
    )
