"""Measured short trials: cost a candidate from the *real* artifacts the
pipeline would lower, not from analytic proxies (DESIGN.md §Autotune).

Where :func:`repro_torch.autotune.cost.predict` estimates from plan accounting,
a measured trial actually builds, for every row of the candidate's
layout, the encoding (:func:`repro_torch.planner.encode_plan` — the bucketed
Eq.5 buffer is the true padded wire size) and, for table-lowered
strategies, the emitted visit tables
(:func:`repro_torch.planner.emit_visit_tables` at the candidate's overlap/grid
settings) — then reads the trial's cost off those artifacts' exact
counters: visited tiles, padded grid steps (rect rectangle vs flat
work-queue width, pow2 bucket padding included), kernel launches per
rank (1 + hops when chunked), and bucketed buffer bytes on the wire.

The trial is deterministic: it times nothing, so identical inputs yield
bit-identical :class:`~repro_torch.autotune.cost.CostEstimate` values in any
process — the property the tuner's cache keys rely on.  A trial timed
on the card would make picks differ between runs and break the cache's
promise; what the card contributes is the constants of
:data:`~repro_torch.autotune.cost_model.HW`, measured once on an H100.
"""

from __future__ import annotations

import numpy as np

from repro_torch.dispatch import imbalance
from repro_torch.planner import encode_plan, get_planner
from repro_torch.planner.encode import emit_visit_tables

from .cost import (CostEstimate, Layout, candidate_layout, comm_seconds,
                   pipeline_exposed, scale_by_imbalance)
from .cost_model import (BLOCK, HW, ModelDims, _attention_block_work,
                         tile_flops)
from .space import Candidate, TuneProblem

__all__ = ["measure_candidate", "measure_many"]

#: (fwd K+V) x (bwd resend + grad exchange) wire factor, as in
#: repro_torch.core.workload.plan_comm_bytes
_TRAIN_WIRE_FACTOR = 4
_INFER_WIRE_FACTOR = 2


def _rank_counters(tabs: dict, overlap: str, degree: int):
    """Per-rank (visited tiles, rect grid steps, flat queue steps,
    kernel launches) summed over local + hop tables."""
    if overlap == "chunked":
        groups = [("tab_loc_", 1)] + ([("tab_hop_", degree - 1)]
                                      if degree > 1 else [])
    else:
        groups = [("tab_", 1)]
    visited = np.zeros(degree)
    rect_steps = np.zeros(degree)
    flat_steps = np.zeros(degree)
    launches = 0
    for prefix, hops in groups:
        nvis = tabs[f"{prefix}kv_nvis"]          # (B, N, [H,] nq)
        idx = tabs[f"{prefix}kv_idx"]            # (B, N, [H,] nq, W)
        fq = tabs[f"{prefix}fq_row"]             # (B, N, [H,] S)
        axes = tuple(a for a in range(nvis.ndim) if a != 1)
        visited += nvis.sum(axis=axes)
        nq, width = idx.shape[-2], idx.shape[-1]
        rect_steps += float(nq * width) * hops * idx.shape[0]
        flat_steps += float(fq.shape[-1]) * hops * fq.shape[0]
        launches += hops
    return visited, rect_steps, flat_steps, launches


def measure_candidate(cand: Candidate, pool, problem: TuneProblem,
                      dims: ModelDims, *, hw: dict = HW,
                      train: bool = True) -> CostEstimate:
    """Cost one candidate from fully-built per-row artifacts.

    Shares :func:`candidate_layout` with ``predict`` — same degree, same
    rows, same groups — so the measured/predicted gap isolates the
    execution model (bucketed wire padding, emitted table widths, launch
    counts) rather than layout differences.
    """
    layout: Layout = candidate_layout(cand, pool, problem)
    degree = layout.cp_degree
    planner = get_planner(cand.cp_strategy)
    style = planner.info.comm_style
    dt = 1 if cand.kv_comm_dtype == "int8" else 2
    fb = 3.0 if train else 1.0
    wire_factor = _TRAIN_WIRE_FACTOR if train else _INFER_WIRE_FACTOR
    align = max(problem.quantum, 1)
    # table emission needs block-divisible rank slices; measure with the
    # kernel's real block when the problem's quantum doesn't pin one
    tables = problem.attention_impl == "flash" and style != "ring"
    if tables:
        align = int(np.lcm(align, BLOCK))

    group = np.zeros(layout.n_groups)
    parts = {k: np.zeros(layout.n_groups) for k in
             ("attn_s", "exposed_comm_s", "comm_s", "linear_s", "other_s",
              "comm_bytes")}
    for r, lens in enumerate(layout.rows):
        if len(lens) == 0:
            continue
        g = int(layout.group_of_row[r])
        plan = planner(lens, degree, validate=False)
        enc = encode_plan(plan, align=align)

        # ---- wire: the *bucketed* Eq.5 buffer is what actually moves --- #
        if degree > 1:
            comm_tokens = enc.buf_len if style == "flashcp" else enc.t_loc
        else:
            comm_tokens = 0
        wire = wire_factor * comm_tokens * dims.kv_heads * dims.head_dim \
            * (degree - 1) * dt
        raw = comm_seconds(wire, hw)

        # ---- attention from emitted tables (or ring blockwise) -------- #
        if tables:
            stack_doc = enc.doc[None]
            stack_pos = enc.pos[None]
            gd = enc.gath_doc[None] if style == "flashcp" else None
            gp = enc.gath_pos[None] if style == "flashcp" else None
            tabs = emit_visit_tables(
                stack_doc, stack_pos, gd, gp, num_workers=degree,
                strategy=style, overlap=cand.cp_overlap, grid="both",
                block_q=BLOCK, block_k=BLOCK, cache=False)
            visited, rect_steps, flat_steps, launches = _rank_counters(
                tabs, cand.cp_overlap, degree)
            steps = rect_steps if cand.kernel_grid == "rect" else flat_steps
            waste = np.maximum(steps - visited, 0.0)
            attn_rank = fb * tile_flops(1.0, dims) * visited \
                / hw["peak_flops"] + waste * hw["grid_step_overhead_s"]
            attn = float(attn_rank.max()) \
                + launches * hw["kernel_overhead_s"]
            busiest = int(np.argmax(attn_rank))
            hop_attn_busiest = _hop_attn(tabs, cand.cp_overlap, busiest,
                                         dims, fb, hw)
        else:
            pairs, n_shards = _attention_block_work(
                plan, ring=(style == "ring"))
            launches = n_shards * (degree if style == "ring" else 1)
            attn = fb * pairs * 2 * dims.head_dim * dims.num_heads * 2 \
                / hw["peak_flops"] + launches * hw["kernel_overhead_s"]
            hop_attn_busiest = None

        # ---- exposed comm under the candidate's overlap mode ---------- #
        t_loc = enc.t_loc
        if degree <= 1 or wire == 0:
            exposed = 0.0
        elif style == "ring":
            merge_s = (degree - 1) * t_loc * dims.num_heads \
                * dims.head_dim * 4 * 2 / hw["hbm_bw"]
            exposed = max(0.0, raw - attn) + merge_s
        elif cand.cp_overlap == "chunked":
            hops = degree - 1
            hop_comm = [raw / hops] * hops
            if hop_attn_busiest is None:
                hop_attn_busiest = [attn * (1 - 1 / degree) / hops] * hops
            merge_s = hops * (wire / hops) * 2.0 / hw["hbm_bw"]
            exposed = pipeline_exposed(hop_comm, hop_attn_busiest) + merge_s
        else:
            exposed = raw

        # ---- copies, quantize passes, linear GEMMs -------------------- #
        other = len(plan.arrays) / degree * hw["copy_overhead_s"] \
            + int(plan.arrays.length.sum()) / degree * dims.kv_heads \
            * dims.head_dim * 2 * 2 / hw["hbm_bw"]
        if dt == 1 and wire > 0:
            other += 2.0 * wire / hw["hbm_bw"]
        d = dims.d_model
        lin_flops = t_loc * (
            2 * d * (dims.num_heads + 2 * dims.kv_heads) * dims.head_dim
            + 2 * dims.num_heads * dims.head_dim * d
            + 2 * 3 * d * dims.d_ff)
        linear = fb * lin_flops / hw["peak_flops"]

        parts["attn_s"][g] += attn
        parts["exposed_comm_s"][g] += exposed
        parts["comm_s"][g] += raw
        parts["linear_s"][g] += linear
        parts["other_s"][g] += other
        parts["comm_bytes"][g] += wire
        group[g] += attn + exposed + other + linear

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


def _hop_attn(tabs: dict, overlap: str, rank: int, dims: ModelDims,
              fb: float, hw: dict) -> list[float] | None:
    """Per-hop partial-attention times of one rank's chunked tables —
    the compute each payload arrival unlocks in the hop pipeline."""
    if overlap != "chunked" or "tab_hop_kv_nvis" not in tabs:
        return None
    nvis = tabs["tab_hop_kv_nvis"]           # (B, N, H, nq)
    if nvis.shape[2] == 0:
        return None
    per_hop = nvis[:, rank].sum(axis=(0, 2))  # (H,)
    return [fb * tile_flops(float(v), dims) / hw["peak_flops"]
            for v in per_hop]


def measure_many(cands, pool, problem: TuneProblem, dims: ModelDims,
                 *, hw: dict = HW, train: bool = True) -> list[CostEstimate]:
    return [measure_candidate(c, pool, problem, dims, hw=hw, train=train)
            for c in cands]
