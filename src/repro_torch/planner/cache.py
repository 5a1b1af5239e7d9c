"""Plan cache keyed by the exact document-length signature.

Long-context training streams draw packed sequences from a stationary
length distribution, so the *same mixes keep recurring* (DCP, arXiv
2510.10620, builds its whole planner tier around this observation).
``PlanCache`` exploits it on the host:

* **signature** — the document lengths plus the exact context length and
  CP size.  For planners whose
  :class:`~repro_torch.planner.registry.PlannerInfo` declares
  ``order_invariant=True`` (FlashCP, Per-Doc) the signature sorts the
  lengths — two packings of the same length multiset share one entry, and
  the cached plan is re-labelled through the sort permutation on the way
  out.  Position-dependent planners (Llama3, contiguous) keep the packed
  order in the key.
* **hit** — the plan is returned with doc ids remapped to the query's
  packing order.  A miss stores the *actual planner output* untouched, so
  a cached pipeline is plan-identical to an uncached one.

Entries are LRU-evicted; hit/miss/eviction statistics are exported for
the pipeline's per-batch stats.  This is the reference's cache at its
default, exact granularity; its quantized signatures (a cached layout
adapted to nearby lengths) and its thread safety are not ported, since
the port plans one sequence after the other and at exact signatures.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from .plan import ShardArrays, ShardingPlan
from .registry import RegisteredPlanner, get_planner

__all__ = ["PlanCache", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0


@dataclasses.dataclass
class _Entry:
    arrays: ShardArrays       # shards in canonical doc-id space
    comm_style: str


class PlanCache:
    """Memoizes ``planner(doc_lens, num_workers)`` across packed sequences."""

    def __init__(self, planner: str | RegisteredPlanner, num_workers: int,
                 *, max_entries: int = 1024,
                 planner_kwargs: dict | None = None):
        self.planner = get_planner(planner) if isinstance(planner, str) \
            else planner
        self.num_workers = int(num_workers)
        self.max_entries = int(max_entries)
        self.planner_kwargs = dict(planner_kwargs or {})
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()

    # ------------------------------------------------------------------ #
    def signature(self, doc_lens) -> tuple[tuple, np.ndarray]:
        """(cache key, canonical permutation) for one packed sequence.

        ``perm`` maps canonical doc index -> query doc index; identity for
        position-dependent planners.
        """
        lens = np.asarray(doc_lens, dtype=np.int64)
        if self.planner.info.order_invariant:
            perm = np.lexsort((np.arange(len(lens)), -lens))
        else:
            perm = np.arange(len(lens))
        key = (self.planner.info.name, self.num_workers, int(lens.sum()),
               lens[perm].tobytes())
        return key, perm

    # ------------------------------------------------------------------ #
    def plan(self, doc_lens) -> ShardingPlan:
        lens = np.asarray(doc_lens, dtype=np.int64)
        key, perm = self.signature(lens)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return self._materialize(entry.arrays, lens, perm,
                                     entry.comm_style)

        # miss: run the planner on the query as-is, store canonically.
        plan = self.planner(lens, self.num_workers, **self.planner_kwargs)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        stored = ShardArrays(inv[plan.arrays.doc_id], plan.arrays.start,
                             plan.arrays.length, plan.arrays.worker)
        self.stats.misses += 1
        self._entries[key] = _Entry(arrays=stored, comm_style=plan.comm_style)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return plan

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------ #
    def _materialize(self, arrays: ShardArrays, lens: np.ndarray,
                     perm: np.ndarray, comm_style: str) -> ShardingPlan:
        """Relabel a canonical-space plan into the query's packing order."""
        remapped = ShardArrays(perm[arrays.doc_id], arrays.start.copy(),
                               arrays.length.copy(), arrays.worker.copy())
        return ShardingPlan(doc_lens=lens, arrays=remapped,
                            num_workers=self.num_workers,
                            comm_style=comm_style)
