"""Autotuner search space: candidates, admissibility, enumeration
(DESIGN.md §Autotune).

A :class:`Candidate` is one point in the discrete run-config space the
tuner searches — exactly the :class:`repro_torch.configs.RunConfig` knobs the
execution engine dispatches on (``cp_strategy``, ``cp_overlap``,
``kernel_grid``, ``dispatch`` + target, ``kv_comm_dtype``).  Enumeration
is *metadata-driven*: strategies come from the planner registry filtered
by family capability (:func:`repro_torch.planner.planners_for_family`) and
mesh/divisibility admissibility is delegated to the dispatcher's own
:func:`repro_torch.dispatch.cp_degree_options` checks (``g | model``, batch
shardability, Eq.2 context division, quantum alignment) so the tuner can
never emit a config the pipeline would reject.

Inert-knob canonicalization keeps the space free of duplicate points
(two candidates that compile to the same program): ``kernel_grid`` is
pinned to ``flat`` unless the run emits the kernels' tables, the dispatch
target is pinned when dispatch is off, and the comm knobs
(``cp_overlap``, ``kv_comm_dtype``) are pinned when no admissible degree
exceeds 1 (no KV ever crosses ranks).  Canonicalization is what makes
"same inputs -> bit-identical tuned config" testable: the emitted list
is sorted by :meth:`Candidate.key` and depends only on its inputs.
"""

from __future__ import annotations

import dataclasses
import itertools

from repro_torch.configs import RunConfig
from repro_torch.dispatch import DispatchConfig, cp_degree_options
from repro_torch.planner import (available_planners, get_planner,
                           planners_for_family)

__all__ = ["Candidate", "SearchSpace", "TuneProblem", "DEFAULT_SPACE",
           "enumerate_candidates", "candidate_degrees",
           "candidate_admissible"]

#: canonical value for the dispatch target when dispatch is off (the
#: knob is inert there; pinning it dedups the space)
_CANON_TARGET = 1.1


@dataclasses.dataclass(frozen=True)
class TuneProblem:
    """The fixed context a search runs against: mesh axes, batch window
    geometry, and the model/runtime facts admissibility depends on."""

    data: int = 1
    model: int = 1
    context_len: int = 4096
    seqs: int = 1
    #: per-worker slice alignment (the pipeline's kernel block size when
    #: ``attention_impl == "flash"``); 0/1 = unconstrained
    quantum: int = 1
    attention_impl: str = "plain"
    family: str = "dense"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the run-config search space (RunConfig overrides)."""

    cp_strategy: str = "flashcp"
    cp_overlap: str = "chunked"            # chunked | none
    kernel_grid: str = "flat"              # flat | rect
    dispatch: str = "off"                  # off | adaptive
    dispatch_target_imbalance: float = _CANON_TARGET
    kv_comm_dtype: str = "native"          # native | int8

    def key(self) -> tuple:
        """Total deterministic order over candidates (ties in every score
        break on this, so selections are process-stable)."""
        return (self.cp_strategy, self.cp_overlap, self.kernel_grid,
                self.dispatch, round(self.dispatch_target_imbalance, 6),
                self.kv_comm_dtype)

    def apply(self, run: RunConfig) -> RunConfig:
        """The tuned RunConfig: ``run`` with this candidate's knobs set."""
        return dataclasses.replace(
            run, cp_strategy=self.cp_strategy, cp_overlap=self.cp_overlap,
            kernel_grid=self.kernel_grid, dispatch=self.dispatch,
            dispatch_target_imbalance=self.dispatch_target_imbalance,
            kv_comm_dtype=self.kv_comm_dtype)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Knob options the enumerator sweeps.  ``strategies=()`` means every
    registered planner admissible for the problem's family."""

    strategies: tuple[str, ...] = ()
    overlaps: tuple[str, ...] = ("chunked", "none")
    grids: tuple[str, ...] = ("flat", "rect")
    dispatch_modes: tuple[str, ...] = ("off", "adaptive")
    dispatch_targets: tuple[float, ...] = (1.05, 1.1, 1.3)
    kv_dtypes: tuple[str, ...] = ("native", "int8")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_SPACE = SearchSpace()


def _dispatch_cfg(problem: TuneProblem, target: float,
                  fixed_cp: int = 0,
                  context_multiple: int = 1) -> DispatchConfig:
    # a planner needing ctx % (k*N) == 0 (llama3's 2N zigzag) gets bins
    # packed to multiples of k*model — divisible by k*g for every g | model
    bq = context_multiple * problem.model if context_multiple > 1 else 1
    return DispatchConfig(
        data=problem.data, model=problem.model, seqs=problem.seqs,
        target_imbalance=target, min_cp=1, fixed_cp=fixed_cp,
        quantum=problem.quantum, bin_quantum=bq)


def _context_multiple(strategy: str) -> int:
    return get_planner(strategy).info.context_multiple


def candidate_degrees(cand: Candidate, problem: TuneProblem) -> list[int]:
    """Admissible CP degrees this candidate may run at, via the
    dispatcher's own divisibility checks.  ``dispatch=off`` pins the full
    model axis (the static pipeline's degree); empty = inadmissible."""
    if cand.cp_strategy not in available_planners():
        return []
    fixed = 0 if cand.dispatch == "adaptive" else problem.model
    cfg = _dispatch_cfg(problem, cand.dispatch_target_imbalance, fixed,
                        _context_multiple(cand.cp_strategy))
    return cp_degree_options(cfg, problem.context_len, strict=False)


def candidate_admissible(cand: Candidate, problem: TuneProblem) -> bool:
    """Re-derivable admissibility predicate (the property tests assert
    every enumerated candidate passes it): the strategy must be
    registered and family-admissible, and at least one CP degree must
    clear the dispatcher's mesh/divisibility gauntlet."""
    if cand.cp_strategy not in available_planners():
        return False
    if cand.cp_strategy not in planners_for_family(problem.family):
        return False
    return bool(candidate_degrees(cand, problem))


def _canonicalize(cand: Candidate, problem: TuneProblem) -> Candidate:
    """Pin inert knobs so distinct candidates are distinct programs."""
    updates: dict = {}
    if problem.attention_impl != "flash":
        # visit tables are never emitted; the grid knob does nothing
        updates["kernel_grid"] = "flat"
    if cand.dispatch == "off":
        updates["dispatch_target_imbalance"] = _CANON_TARGET
    degrees = candidate_degrees(cand, problem)
    if degrees and max(degrees) <= 1:
        # no admissible degree moves KV across ranks: the comm knobs are
        # inert — pin them to the RunConfig defaults
        updates["cp_overlap"] = "chunked"
        updates["kv_comm_dtype"] = "native"
    return dataclasses.replace(cand, **updates) if updates else cand


def enumerate_candidates(problem: TuneProblem,
                         space: SearchSpace = DEFAULT_SPACE
                         ) -> list[Candidate]:
    """Every admissible, canonical candidate of ``space`` for ``problem``,
    deduplicated and sorted by :meth:`Candidate.key`.

    Deterministic by construction: option tuples are iterated in given
    order, the registry listing is sorted, and the output order depends
    only on the (problem, space) inputs — never on hashing or RNG.
    """
    # default strategy set: family-admissible planners, minus reference
    # solvers too expensive to plan every batch with (cost_hint
    # "exponential" — bnb exists for Table 2, not production steps)
    strategies = space.strategies or tuple(
        s for s in planners_for_family(problem.family)
        if get_planner(s).info.cost_hint != "exponential")
    out: dict[tuple, Candidate] = {}
    for strat, overlap, grid, mode in itertools.product(
            strategies, space.overlaps, space.grids, space.dispatch_modes):
        targets = space.dispatch_targets if mode == "adaptive" \
            else (_CANON_TARGET,)
        for target, dtype in itertools.product(targets, space.kv_dtypes):
            cand = Candidate(
                cp_strategy=strat, cp_overlap=overlap, kernel_grid=grid,
                dispatch=mode, dispatch_target_imbalance=float(target),
                kv_comm_dtype=dtype)
            if not candidate_admissible(cand, problem):
                continue
            cand = _canonicalize(cand, problem)
            out.setdefault(cand.key(), cand)
    return [out[k] for k in sorted(out)]
