"""Two-stage config search: predict-prune-measure (DESIGN.md §Autotune).

:func:`tune` enumerates the admissible candidate space
(:func:`repro_torch.autotune.space.enumerate_candidates`), scores every
candidate with the analytic :func:`repro_torch.autotune.cost.predict`, prunes
to the top-K predicted frontier (:func:`prune_topk` — deterministic
``(score, candidate key)`` order, so ties never depend on enumeration
order), runs the deterministic measured trial
(:func:`repro_torch.autotune.measure.measure_candidate`) on each survivor, and
selects the measured argmin.  The tuned knobs applied to the caller's
base :class:`~repro_torch.configs.RunConfig` are the emitted artifact; the
whole result serializes to a canonical-JSON payload stored in the
content-addressed :class:`~repro_torch.autotune.cache.ResultCache`.

Search correctness contract (property-tested in
``tests/test_autotune.py``):

* pruning never drops the optimum when the predictor ranks like the
  measurement (and with ``top_k >= |space|`` the search *is* brute
  force regardless of the predictor);
* the search is a pure function of its inputs — same pool, problem,
  dims, space, K -> byte-identical payload in any process;
* a cache round trip returns the identical payload without re-measuring.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.configs import RunConfig, run_config_to_dict

from .cache import ResultCache, signature_key, tune_signature
from .cost import CostEstimate, predict, spearman
from .cost_model import HW, ModelDims
from .measure import measure_candidate
from .space import (DEFAULT_SPACE, Candidate, SearchSpace, TuneProblem,
                    enumerate_candidates)

__all__ = ["TuneResult", "tune", "prune_topk", "brute_force",
           "autotune_run"]


@dataclasses.dataclass
class TuneResult:
    """Outcome of one :func:`tune` call."""

    best: Candidate
    best_measured: dict              # CostEstimate dict of the winner
    run_config: dict                 # tuned RunConfig (base + best knobs)
    frontier: list                   # [{candidate, predicted, measured}]
    candidates: list                 # [{candidate, predicted}] whole space
    n_candidates: int
    top_k: int
    spearman_frontier: float         # predicted-vs-measured on survivors
    key: str                         # content-address of the signature
    cached: bool = False             # served from the result cache

    def payload(self) -> dict:
        """The cacheable, deterministic part (no base-run fields, no
        cached flag — those are call-site facts, not search results)."""
        from .cache import TUNER_VERSION
        return {
            "version": TUNER_VERSION,
            "key": self.key,
            "best": self.best.as_dict(),
            "best_measured": self.best_measured,
            "frontier": self.frontier,
            "candidates": self.candidates,
            "n_candidates": self.n_candidates,
            "top_k": self.top_k,
            "spearman_frontier": self.spearman_frontier,
        }

    def to_json(self) -> str:
        """Canonical JSON of the search outcome — the bytes the
        determinism property compares across processes."""
        return json.dumps(self.payload(), sort_keys=True,
                          separators=(",", ":"))


def prune_topk(cands: list[Candidate], ests: list[CostEstimate],
               k: int) -> list[tuple[Candidate, CostEstimate]]:
    """The K best-predicted candidates in deterministic order.

    Sorted by ``(predicted step time, candidate key)`` — the key
    tiebreak makes the frontier (and therefore everything downstream)
    independent of input order.  ``k >= len(cands)`` is the identity
    (modulo that canonical re-ordering): pruning can then never drop
    anything, which is the brute-force escape hatch the property tests
    exploit.
    """
    order = sorted(range(len(cands)),
                   key=lambda i: (ests[i].step_s, cands[i].key()))
    return [(cands[i], ests[i]) for i in order[:max(k, 1)]]


def brute_force(cands: list[Candidate], costs: list[CostEstimate]
                ) -> tuple[Candidate, CostEstimate]:
    """Exhaustive argmin under the same ``(score, key)`` order the
    search uses — the reference the prune property compares against."""
    i = min(range(len(cands)),
            key=lambda i: (costs[i].step_s, cands[i].key()))
    return cands[i], costs[i]


def tune(pool, problem: TuneProblem, dims: ModelDims, *,
         base_run: RunConfig | None = None,
         space: SearchSpace = DEFAULT_SPACE,
         top_k: int = 8,
         cache: ResultCache | None = None,
         hw: dict = HW,
         train: bool = True,
         predict_fn=None,
         measure_fn=None) -> TuneResult:
    """Run the two-stage search; see module docstring.

    ``predict_fn`` / ``measure_fn`` override the scoring stages
    (signature ``fn(candidate, pool, problem, dims)``) — the property
    tests inject synthetic cost models; production callers leave the
    defaults.
    """
    pool = np.asarray(pool, dtype=np.int64)
    base_run = base_run if base_run is not None else RunConfig()
    pred = predict_fn or (lambda c, p, pr, dm:
                          predict(c, p, pr, dm, hw=hw, train=train))
    meas = measure_fn or (lambda c, p, pr, dm:
                          measure_candidate(c, p, pr, dm, hw=hw,
                                            train=train))
    key = signature_key(tune_signature(problem, dims, pool, space, hw))

    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            best = Candidate(**hit["best"])
            return TuneResult(
                best=best, best_measured=hit["best_measured"],
                run_config=run_config_to_dict(best.apply(base_run)),
                frontier=hit["frontier"], candidates=hit["candidates"],
                n_candidates=hit["n_candidates"], top_k=hit["top_k"],
                spearman_frontier=hit["spearman_frontier"], key=key,
                cached=True)

    cands = enumerate_candidates(problem, space)
    if not cands:
        raise ValueError(
            f"no admissible candidate for problem {problem}: the mesh / "
            f"divisibility constraints reject the whole space")
    predicted = [pred(c, pool, problem, dims) for c in cands]
    frontier = prune_topk(cands, predicted, top_k)
    measured = [meas(c, pool, problem, dims) for c, _ in frontier]
    best, best_m = brute_force([c for c, _ in frontier], measured)

    rho = spearman([p.step_s for _, p in frontier],
                   [m.step_s for m in measured]) if len(frontier) > 1 \
        else 1.0
    result = TuneResult(
        best=best,
        best_measured=best_m.as_dict(),
        run_config=run_config_to_dict(best.apply(base_run)),
        frontier=[{"candidate": c.as_dict(), "predicted": p.as_dict(),
                   "measured": m.as_dict()}
                  for (c, p), m in zip(frontier, measured)],
        candidates=[{"candidate": c.as_dict(), "predicted": p.as_dict()}
                    for c, p in zip(cands, predicted)],
        n_candidates=len(cands),
        top_k=top_k,
        spearman_frontier=rho,
        key=key)
    if cache is not None:
        cache.put(key, result.payload())
    return result


def autotune_run(run: RunConfig, cfg, *, data: int, model: int,
                 context_len: int, seqs: int, dataset: str = "wlb_llm",
                 cache_dir: str = "", top_k: int = 8,
                 space: SearchSpace = DEFAULT_SPACE, hw: dict = HW
                 ) -> tuple[RunConfig, TuneResult]:
    """Tune a training run's config knobs before launch
    (``train.py --autotune``).

    Samples one representative document pool from the run's own dataset
    stream (seeded by ``run.seed`` — deterministic, and the same
    distribution every training step draws from), derives the
    :class:`TuneProblem` from the mesh and the pipeline's alignment
    rules, and returns ``(tuned RunConfig, TuneResult)``.  ``hw`` (the
    cost constants) is passed through to :func:`tune`.
    """
    from repro_torch.configs import run_config_from_dict
    from repro_torch.data.packing import sample_doc_pool

    align = 128 if run.attention_impl == "flash" \
        else (1 if data * model == 1 else 16)
    problem = TuneProblem(
        data=data, model=model, context_len=context_len, seqs=seqs,
        quantum=align, attention_impl=run.attention_impl,
        family=cfg.family)
    dims = ModelDims(
        num_heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, d_model=cfg.d_model,
        d_ff=cfg.d_ff)
    rng = np.random.default_rng(run.seed)
    pool = sample_doc_pool(dataset, seqs * context_len, rng,
                           max_doc_len=context_len, min_docs=seqs)
    result = tune(pool, problem, dims, base_run=run, space=space,
                  top_k=top_k, cache=ResultCache(cache_dir or None), hw=hw)
    return run_config_from_dict(result.run_config), result
