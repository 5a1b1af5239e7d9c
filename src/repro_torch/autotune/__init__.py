"""Cost-model-driven config autotuner (DESIGN.md §Autotune).

Turns the engine's independent run-config knobs (``cp_strategy``,
``cp_overlap``, ``kernel_grid``, ``dispatch`` + target,
``kv_comm_dtype``) into one search: enumerate the admissible space from
planner capability metadata and the dispatcher's mesh/divisibility
checks, score every candidate with the unified analytic cost model,
prune to a top-K predicted frontier, run deterministic measured trials
on the survivors, and emit a tuned, serializable
:class:`~repro_torch.configs.RunConfig` behind a content-addressed result
cache.  Entry points: ``train.py --autotune`` and
``scripts/autotune_torch.py``.

Host-side numpy only, the port's copy of the reference's
``repro.autotune``: ``attention_impl`` is the port's ``"flash"`` (the
reference's ``"pallas"``) or ``"plain"`` (its ``"xla"``), the cost
constants are an H100's, and the cache signature carries them.
"""

from .cache import (LENGTH_QUANTUM, TUNER_VERSION, ResultCache,
                    signature_key, tune_signature)
from .cost import (CostEstimate, Layout, candidate_layout, comm_seconds,
                   pipeline_exposed, predict, scale_by_imbalance, spearman)
from .cost_model import (BLOCK, HW, L_HALF, ModelDims, step_breakdown,
                         visited_tile_counts)
from .measure import measure_candidate, measure_many
from .search import TuneResult, autotune_run, brute_force, prune_topk, tune
from .space import (DEFAULT_SPACE, Candidate, SearchSpace, TuneProblem,
                    candidate_admissible, candidate_degrees,
                    enumerate_candidates)

__all__ = [
    "LENGTH_QUANTUM", "TUNER_VERSION", "ResultCache", "signature_key",
    "tune_signature",
    "CostEstimate", "Layout", "candidate_layout", "comm_seconds",
    "pipeline_exposed", "predict", "scale_by_imbalance", "spearman",
    "BLOCK", "HW", "L_HALF", "ModelDims", "step_breakdown",
    "visited_tile_counts",
    "measure_candidate", "measure_many",
    "TuneResult", "autotune_run", "brute_force", "prune_topk", "tune",
    "DEFAULT_SPACE", "Candidate", "SearchSpace", "TuneProblem",
    "candidate_admissible", "candidate_degrees", "enumerate_candidates",
]
