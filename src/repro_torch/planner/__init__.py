"""FlashCP planning stack of the port (host-side numpy; the port's own
copy of the reference's ``repro.planner``):

* :mod:`.plan`      — ``ShardArrays`` shard storage, ``ShardingPlan`` and
  vectorized validation/accounting;
* :mod:`.registry`  — ``@register_planner`` / :func:`get_planner` with
  per-planner capability metadata (:class:`PlannerInfo`);
* :mod:`.heuristic` — Algorithm 1 (FlashCP), vectorized;
* :mod:`.baselines` — Llama3 / Per-Doc / Ring / contiguous, and the
  registered flashcp adapter;
* :mod:`.ilp`       — the exact branch-and-bound reference (``bnb``, alias
  ``ilp``);
* :mod:`.encode`    — plan -> static-shaped arrays and visit tables;
* :mod:`.cache`     — ``PlanCache`` keyed by (quantized) doc-length
  signature;
* :mod:`.parallel`  — the multi-sequence planning thread pool.
"""

from .plan import (Shard, ShardArrays, ShardingPlan, make_whole_doc_plan,
                   merge_adjacent_shards, shard_workload_array,
                   validate_plan)
from .registry import (RECURRENT_FAMILIES, Planner, PlannerInfo,
                       RegisteredPlanner, available_planners, get_planner,
                       planner_info, planners_for_family, register_planner)
from .heuristic import HeuristicStats, flashcp_plan, zigzag_doc_shards
from .baselines import (contiguous_plan, llama3_plan, per_doc_plan,
                        ring_zigzag_plan)
from .ilp import BnBResult, bnb_plan
from .encode import (PlanEncoding, emit_visit_tables, encode_plan,
                     encode_plan_batch, pick_buffer_bucket,
                     plan_shape_hints, trivial_plan, visit_table_shapes)
from .cache import CacheStats, PlanCache
from .parallel import PlannerPool, default_workers, get_pool, plan_many

__all__ = [
    "Shard", "ShardArrays", "ShardingPlan", "make_whole_doc_plan",
    "merge_adjacent_shards", "shard_workload_array", "validate_plan",
    "Planner", "PlannerInfo", "RegisteredPlanner", "available_planners",
    "get_planner", "planner_info", "planners_for_family",
    "RECURRENT_FAMILIES", "register_planner",
    "HeuristicStats", "flashcp_plan", "zigzag_doc_shards",
    "contiguous_plan", "llama3_plan", "per_doc_plan", "ring_zigzag_plan",
    "BnBResult", "bnb_plan",
    "PlanEncoding", "encode_plan", "encode_plan_batch",
    "emit_visit_tables", "visit_table_shapes",
    "pick_buffer_bucket", "plan_shape_hints", "trivial_plan",
    "CacheStats", "PlanCache",
    "PlannerPool", "default_workers", "get_pool", "plan_many",
]
