"""Exact reference optimizer for the sharding problem (paper §3.4, Table 2;
the port's copy of the reference's ``repro.planner.ilp``).

The paper formulates sharding as an ILP over shard-to-worker assignments
(Eq. 1-3 plus the Eq. 5 communication term) and reports that a commercial
solver needs tens of minutes per sequence.  This module is an **exact
branch-and-bound search** in the same role: an optimality reference
against which the heuristic's communication saving and imbalance ratio
are judged.

Search space: every document is assigned whole to one of the N workers
(branching, with worker-symmetry breaking and feasibility pruning); each
complete assignment is made Eq.2-feasible with the deterministic minimal
head-cut repair operator shared with the heuristic
(:func:`repro_torch.planner.heuristic._repair_equal_tokens`).  The
objective

    J(plan) = imbalance_ratio(plan) + lambda_comm * comm_tokens / (C / N)

is evaluated exactly on the repaired plan.  The nodes are visited in the
reference's order (documents longest first, candidate workers least
loaded first), so ``nodes_explored`` and the returned plan are the
reference's; ``tests/test_torch_planner_ilp.py`` holds both.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .heuristic import _ArrayState, _repair_equal_tokens, flashcp_plan
from .plan import ShardingPlan, validate_plan
from .registry import register_planner

__all__ = ["bnb_plan", "BnBResult"]


@dataclasses.dataclass
class BnBResult:
    plan: ShardingPlan
    objective: float
    nodes_explored: int
    proven_optimal: bool


def _evaluate(doc_lens: np.ndarray, assignment: list[int], num_workers: int,
              lambda_comm: float) -> tuple[float, ShardingPlan]:
    """Build + repair a plan for a complete whole-doc assignment; score it."""
    state = _ArrayState(num_workers,
                        np.zeros(num_workers, np.int64),
                        np.zeros(num_workers, np.float64), doc_lens)
    for did, w in enumerate(assignment):
        state.add(did, 0, int(doc_lens[did]), w)
    target = int(doc_lens.sum()) // num_workers
    _repair_equal_tokens(state, target)
    plan = ShardingPlan(doc_lens=doc_lens, arrays=state.to_arrays().merged(),
                        num_workers=num_workers, comm_style="flashcp")
    obj = plan.imbalance_ratio() + lambda_comm * plan.comm_tokens() / target
    return obj, plan


def bnb_plan(
    doc_lens: Sequence[int],
    num_workers: int,
    *,
    lambda_comm: float = 0.5,
    max_nodes: int = 2_000_000,
    validate: bool = True,
) -> BnBResult:
    """The best plan of the search, its objective, the nodes visited and
    whether the whole tree was searched (``max_nodes`` not reached and
    the search beat the heuristic's incumbent)."""
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    n = len(doc_lens)
    N = num_workers
    ctx = int(doc_lens.sum())
    if ctx % N:
        raise ValueError(f"context {ctx} does not split over {N} workers")
    target = ctx // N
    total_work = float(sum((d + 1) * d / 2.0 for d in doc_lens))

    # docs in decreasing length: big decisions first => strong pruning.
    order = sorted(range(n), key=lambda i: (-int(doc_lens[i]), i))

    best_obj = np.inf
    best_assignment: list[int] | None = None
    nodes = 0
    exhausted = True

    # the heuristic's plan: the result where the search finds no better
    heur_plan, _ = flashcp_plan(doc_lens, N, validate=False)
    heur_obj = heur_plan.imbalance_ratio() + \
        lambda_comm * heur_plan.comm_tokens() / target

    # Global lower bound: perfect balance, zero comm -> J >= 1.0.
    global_lb = 1.0

    tokens = np.zeros(N, dtype=np.int64)
    work = np.zeros(N, dtype=np.float64)
    assignment_by_doc = [0] * n

    def max_sheddable() -> float:
        """Upper bound on the workload the max-loaded worker could shed
        by head cuts during repair: its tokens above target, each moving
        at most ``max doc len`` pair evaluations."""
        j = int(np.argmax(work))
        excess = max(int(tokens[j]) - target, 0)
        return float(excess) * float(doc_lens.max() if len(doc_lens) else 0)

    def dfs(idx: int, used_workers: int) -> None:
        nonlocal best_obj, best_assignment, nodes, exhausted
        nodes += 1
        if nodes > max_nodes:
            exhausted = False
            return
        if best_obj <= global_lb + 1e-12:
            return
        if idx == n:
            obj, _ = _evaluate(doc_lens, assignment_by_doc, N, lambda_comm)
            if obj < best_obj:
                best_obj = obj
                best_assignment = list(assignment_by_doc)
            return

        did = order[idx]
        d = int(doc_lens[did])
        remaining = int(doc_lens[[order[k] for k in range(idx + 1, n)]].sum()) \
            if idx + 1 < n else 0

        # bound: the *workload* part of J can never beat
        # max(current max work, total/N) / (total/N); comm part >= 0.
        lb_work = max(float(np.max(work)) - max_sheddable(), total_work / N)
        if lb_work / (total_work / N) >= best_obj - 1e-12:
            return

        # candidate workers: all used ones + one fresh (symmetry breaking),
        # least-loaded first for good incumbents.
        cand = list(range(min(used_workers + 1, N)))
        cand.sort(key=lambda j: work[j])
        for j in cand:
            # a worker's token excess can always be repaired by cuts, but
            # if the deficits elsewhere cannot absorb remaining + excess,
            # prune.
            tokens[j] += d
            work[j] += (d + 1) * d / 2.0
            total_excess = int(np.maximum(tokens - target, 0).sum())
            total_deficit = int(np.maximum(target - tokens, 0).sum())
            if total_excess <= total_deficit + remaining:
                assignment_by_doc[did] = j
                dfs(idx + 1, max(used_workers, j + 1))
            tokens[j] -= d
            work[j] -= (d + 1) * d / 2.0
            if nodes > max_nodes:
                exhausted = False
                break

    dfs(0, 0)

    if best_assignment is None or heur_obj < best_obj:
        # the heuristic beat the search (or it completed no leaf)
        if validate:
            validate_plan(heur_plan)
        return BnBResult(plan=heur_plan, objective=float(heur_obj),
                         nodes_explored=nodes, proven_optimal=False)

    _, plan = _evaluate(doc_lens, best_assignment, N, lambda_comm)
    if validate:
        validate_plan(plan)
    return BnBResult(plan=plan, objective=float(best_obj),
                     nodes_explored=nodes, proven_optimal=exhausted)


@register_planner(
    "bnb", aliases=("ilp",),
    description="Exact branch-and-bound optimality reference (paper §3.4 "
                "ILP analogue); small instances only",
    comm_style="flashcp", exec_style="flashcp",
    order_invariant=True, cost_hint="exponential")
def _bnb_adapter(doc_lens, num_workers, *, validate=True,
                 lambda_comm: float = 0.5, max_nodes: int = 2_000_000):
    return bnb_plan(doc_lens, num_workers, lambda_comm=lambda_comm,
                    max_nodes=max_nodes, validate=validate).plan
