"""Unified candidate scoring: ``predict(candidate, pool, problem, dims)
-> CostEstimate`` (DESIGN.md §Autotune).

Merges the repo's three cost sources into one ranking function:

* :func:`repro_torch.autotune.cost_model.step_breakdown` — per-plan analytic
  attention / comm / copy / GEMM roofline terms;
* a two-stream (compute vs collective) hop pipeline
  (:func:`pipeline_exposed`) credits chunked-overlap candidates with the
  compute their per-hop payloads hide: the CP island's hop h+1 flies
  while hop h's partial attention runs
  (:func:`repro_torch.core.cp_attention._run_hops`);
* :mod:`repro_torch.dispatch.balance` imbalance simulation — candidates are
  laid out with the *actual* dispatcher (adaptive) or the static packer
  (off), and the step estimate is the max over CP-group completion
  times, expressed through :func:`scale_by_imbalance`.

Monotonicity contract (property-tested): :func:`comm_seconds` is
monotone non-decreasing in wire bytes, :func:`pipeline_exposed` in every
hop's comm time, and :func:`scale_by_imbalance` in the imbalance ratio —
more modeled comm volume never predicts less comm time; higher imbalance
never predicts lower step time.

Everything here is deterministic host-side numpy: predictions depend
only on (candidate, pool, problem, dims, hw), never on RNG or wall
clock, which is what makes search results cache-stable across processes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.dispatch import dispatch_step, imbalance, pack_pool
from repro_torch.planner import get_planner

from .cost_model import (BLOCK, HW, ModelDims, step_breakdown, tile_flops,
                         visited_tile_counts)
from .space import Candidate, TuneProblem, candidate_degrees, _dispatch_cfg

__all__ = ["CostEstimate", "Layout", "candidate_layout", "predict",
           "comm_seconds", "pipeline_exposed", "scale_by_imbalance",
           "spearman"]


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One candidate's scored step cost (predicted or measured)."""

    step_s: float            # the ranking objective
    attn_s: float
    exposed_comm_s: float    # comm residue on the critical path
    comm_s: float            # raw wire time (pre-overlap credit)
    linear_s: float
    other_s: float
    comm_bytes: float
    cp_degree: int
    n_groups: int
    work_imbalance: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------ #
# monotone primitives
# ------------------------------------------------------------------ #
def comm_seconds(wire_bytes: float, hw: dict = HW) -> float:
    """Wire time of a KV exchange; monotone in ``wire_bytes``."""
    return max(float(wire_bytes), 0.0) / hw["ici_bw"]


def pipeline_exposed(hop_comm_s: Sequence[float],
                     hop_compute_s: Sequence[float]) -> float:
    """Exposed comm of a chunked hop pipeline (two-resource schedule).

    Hop payloads transfer back-to-back on the comm stream; hop ``h``'s
    partial-attention compute starts once its payload arrived *and* the
    compute stream is free.  Exposed = compute-stream makespan minus its
    busy time.  Monotone non-decreasing in every ``hop_comm_s`` entry and
    non-increasing in every ``hop_compute_s`` entry.
    """
    t_comm = 0.0
    t_comp = 0.0
    busy = 0.0
    for c_s, k_s in zip(hop_comm_s, hop_compute_s):
        t_comm += max(float(c_s), 0.0)
        t_comp = max(t_comp, t_comm) + max(float(k_s), 0.0)
        busy += max(float(k_s), 0.0)
    return max(0.0, t_comp - busy)


def scale_by_imbalance(balanced_s: float, imb: float) -> float:
    """Step time from mean group time and a max/mean imbalance ratio;
    monotone in both arguments (ratios below 1 are clamped)."""
    return max(float(balanced_s), 0.0) * max(float(imb), 1.0)


def spearman(pred: Sequence[float], meas: Sequence[float]) -> float:
    """Spearman rank correlation (tie-averaged ranks, pure numpy — the CI
    image has no scipy).  Two constant vectors agree perfectly (1.0); a
    constant vector against a varying one carries no rank signal (0.0)."""
    a, b = _ranks(pred), _ranks(meas)
    sa, sb = a.std(), b.std()
    if len(a) < 2 or (sa == 0.0 and sb == 0.0):
        return 1.0
    if sa == 0.0 or sb == 0.0:
        return 0.0
    return float(((a - a.mean()) * (b - b.mean())).mean() / (sa * sb))


def _ranks(x: Sequence[float]) -> np.ndarray:
    v = np.asarray(x, dtype=np.float64)
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), dtype=np.float64)
    ranks[order] = np.arange(len(v), dtype=np.float64)
    # average ranks over ties so equal scores compare as equal
    sv = v[order]
    i = 0
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


# ------------------------------------------------------------------ #
# candidate layout: which rows run at which degree in which group
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class Layout:
    """A candidate's simulated batch layout, shared verbatim between
    ``predict`` and the measured trial so the two scores differ only in
    how each row is costed — never in what runs where."""

    cp_degree: int
    n_groups: int
    rows: tuple                      # per-row doc-length arrays, group-major
    group_of_row: np.ndarray         # (seqs,) int64


def candidate_layout(cand: Candidate, pool: np.ndarray,
                     problem: TuneProblem) -> Layout:
    """Lay the pool out exactly as the pipeline would under ``cand``:
    the real dispatcher for ``adaptive`` (degree choice + LPT balancing),
    the static worst-fit packer with in-order group assignment for
    ``off`` (no cross-rank balancing — the baseline's weakness the
    dispatcher exists to fix)."""
    pool = np.asarray(pool, dtype=np.int64)
    mult = get_planner(cand.cp_strategy).info.context_multiple
    if cand.dispatch == "adaptive":
        cfg = _dispatch_cfg(problem, cand.dispatch_target_imbalance,
                            context_multiple=mult)
        dp = dispatch_step(pool, cfg, problem.context_len)
        return Layout(dp.cp_degree, dp.n_groups, tuple(dp.rows),
                      np.asarray(dp.group_of_row, dtype=np.int64))
    degree = candidate_degrees(cand, problem)[-1]      # the full model axis
    packed = pack_pool(pool, problem.seqs, problem.context_len,
                       quantum=int(np.lcm(degree * mult,
                                          max(problem.quantum, 1))))
    n_groups = problem.data * problem.model // degree
    per_group = problem.seqs // n_groups
    group_of_row = np.arange(problem.seqs, dtype=np.int64) // per_group
    return Layout(degree, n_groups, tuple(packed.bins), group_of_row)


# ------------------------------------------------------------------ #
# prediction
# ------------------------------------------------------------------ #
def _overlap_exposed(cand: Candidate, comm_bytes: float, attn_s: float,
                     degree: int, hw: dict) -> float:
    """Exposed comm of one row under the candidate's overlap mode.

    Ring plans already carry their hop-overlap credit inside
    ``step_breakdown``; for the collective styles, ``chunked`` pipelines
    the (N-1) payload hops against the partial attention each hop
    unlocks (the gathered-KV share of the row's attention), plus a
    per-hop online-LSE merge pass; ``none`` exposes the full wire time.
    """
    raw = comm_seconds(comm_bytes, hw)
    if degree <= 1 or comm_bytes <= 0:
        return 0.0
    if cand.cp_overlap != "chunked":
        return raw
    hops = degree - 1
    # attention attributable to gathered (non-local) KV — the compute a
    # hop's arrival unlocks; 1/degree of the work is local-only.
    hop_attn = attn_s * (1.0 - 1.0 / degree) / hops
    merge_s = hops * (comm_bytes / hops) \
        * 2.0 / hw["hbm_bw"]          # fp32 partial/LSE read+write per hop
    return pipeline_exposed([raw / hops] * hops, [hop_attn] * hops) + merge_s


def _pow2_bucket(x: np.ndarray, floor: int = 8) -> np.ndarray:
    """Vectorized ``encode._next_pow2``: next power of two, floored."""
    x = np.maximum(np.ceil(x), 1.0)
    return np.maximum(2.0 ** np.ceil(np.log2(x)), float(floor))


def _tables_attn_s(cand: Candidate, plan, degree: int, dims: ModelDims,
                   hw: dict, fb: float) -> float:
    """Attention time of one row when the doc kernels' visit tables are
    emitted — the *same formula the measured trial reads off the emitted
    tables* (raw visited-tile tensor-core work + padded grid-step waste + per-launch
    overhead), evaluated on analytic per-worker counters instead of the
    tables themselves.  Sharing the formula is what keeps predicted and
    measured scores rank-consistent on the table path; the analytic
    ``_kernel_eff`` curve models monolithic flash kernels and does not
    apply — the table kernel's short-shard penalty *is* the padding and
    launch terms.
    """
    t = visited_tile_counts(plan)
    nq = np.ceil(plan.context_len / plan.num_workers / BLOCK)
    rect = nq * _pow2_bucket(t["kv_tiles_max"])
    if cand.kernel_grid == "rect":
        steps = rect
    else:
        # the flat queue's pow2 bucket never exceeds the full rectangle
        steps = np.minimum(_pow2_bucket(t["visited"]), rect)
    waste = np.maximum(steps - t["visited"], 0.0)
    per_rank = fb * tile_flops(1.0, dims) * t["visited"] \
        / hw["peak_flops"] + waste * hw["grid_step_overhead_s"]
    hops = degree - 1 if cand.cp_overlap == "chunked" and degree > 1 else 0
    launches = 1 + hops
    return float(per_rank.max()) + launches * hw["kernel_overhead_s"]


def predict(cand: Candidate, pool, problem: TuneProblem, dims: ModelDims,
            *, hw: dict = HW, train: bool = True) -> CostEstimate:
    """Analytic step-cost estimate of one candidate on one document pool.

    Per row of the candidate's layout: plan with the candidate's
    strategy at the layout degree, take the analytic
    :func:`step_breakdown`, then apply the candidate's execution
    adjustments (overlap pipelining, rect-grid waste, int8 wire +
    quantize passes).  Rows sum within a CP group (they run
    back-to-back on the same devices); the step estimate is the mean
    group time scaled by the max/mean group imbalance — identically the
    max, but routed through the monotone :func:`scale_by_imbalance`.
    """
    layout = candidate_layout(cand, pool, problem)
    degree = layout.cp_degree
    planner = get_planner(cand.cp_strategy)
    dt = 1 if cand.kv_comm_dtype == "int8" else 2
    fb = 3.0 if train else 1.0

    group = np.zeros(layout.n_groups)
    parts = {"attn_s": np.zeros(layout.n_groups),
             "exposed_comm_s": np.zeros(layout.n_groups),
             "comm_s": np.zeros(layout.n_groups),
             "linear_s": np.zeros(layout.n_groups),
             "other_s": np.zeros(layout.n_groups),
             "comm_bytes": np.zeros(layout.n_groups)}
    for r, lens in enumerate(layout.rows):
        if len(lens) == 0:
            continue
        g = int(layout.group_of_row[r])
        plan = planner(lens, degree, validate=False)
        bd = step_breakdown(plan, dims, train=train, hw=hw, dtype_bytes=dt)
        tables = problem.attention_impl == "flash" \
            and plan.comm_style != "ring"
        attn = _tables_attn_s(cand, plan, degree, dims, hw, fb) if tables \
            else bd["attn_s"]
        raw = comm_seconds(bd["comm_bytes"], hw)
        if plan.comm_style == "ring":
            exposed = bd["comm_s"]       # hop credit already applied
        else:
            exposed = _overlap_exposed(cand, bd["comm_bytes"], attn,
                                       degree, hw)
        other = bd["other_s"]
        if dt == 1 and bd["comm_bytes"] > 0:
            # quantize + dequantize memory passes over the wire payload
            other += 2.0 * bd["comm_bytes"] / hw["hbm_bw"]
        parts["attn_s"][g] += attn
        parts["exposed_comm_s"][g] += exposed
        parts["comm_s"][g] += raw
        parts["linear_s"][g] += bd["linear_s"]
        parts["other_s"][g] += other
        parts["comm_bytes"][g] += bd["comm_bytes"]
        group[g] += attn + exposed + other + bd["linear_s"]

    imb = imbalance(group) if group.any() else 1.0
    gmax = int(np.argmax(group))
    return CostEstimate(
        step_s=scale_by_imbalance(float(group.mean()), imb),
        attn_s=float(parts["attn_s"][gmax]),
        exposed_comm_s=float(parts["exposed_comm_s"][gmax]),
        comm_s=float(parts["comm_s"][gmax]),
        linear_s=float(parts["linear_s"][gmax]),
        other_s=float(parts["other_s"][gmax]),
        comm_bytes=float(parts["comm_bytes"][gmax]),
        cp_degree=degree,
        n_groups=layout.n_groups,
        work_imbalance=float(imb),
    )
