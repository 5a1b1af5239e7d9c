"""Plan cache keyed by a (quantized) document-length signature.

Long-context training streams draw packed sequences from a stationary
length distribution, so the *same mixes keep recurring* (DCP, arXiv
2510.10620, builds its whole planner tier around this observation).
``PlanCache`` exploits it on the host:

* **signature** — the document lengths, optionally bucketed to a
  ``granularity`` (ceil to multiples of g), plus the exact context length
  and CP size.  For planners whose
  :class:`~repro_torch.planner.registry.PlannerInfo` declares
  ``order_invariant=True`` (FlashCP, Per-Doc) the signature sorts the
  lengths — two packings of the same length multiset share one entry, and
  the cached plan is re-labelled through the sort permutation on the way
  out.  Position-dependent planners (Llama3, contiguous) keep the packed
  order in the key.
* **exact hit** — the stored plan's document lengths match exactly: the
  plan is returned with doc ids remapped to the query's packing order.
  A miss stores the *actual planner output* untouched, so a cached
  pipeline is plan-identical to an uncached one at ``granularity=1``.
* **quantized hit** (``granularity > 1``) — the signature matches but the
  exact lengths differ by less than one bucket per document: the cached
  shard layout is *adapted* (per-document boundaries clamped to the new
  lengths, then the heuristic's equal-token repair restores Eq. 2) and
  validated.  If the adapted plan fails validation the query is re-planned
  (counted as a miss).

Entries are LRU-evicted; hit/miss/adapt statistics are exported for the
pipeline's per-batch stats.  The public methods are thread-safe: the
pipeline plans a batch's sequences on the planner pool
(:mod:`repro_torch.planner.parallel`).  The port's copy of the
reference's ``repro.planner.cache``, statistics included.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np

from .heuristic import _ArrayState, _repair_equal_tokens
from .plan import ShardArrays, ShardingPlan, validate_plan
from .registry import RegisteredPlanner, get_planner

__all__ = ["PlanCache", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    quantized_hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.quantized_hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return (self.hits + self.quantized_hits) / n if n else 0.0


@dataclasses.dataclass
class _Entry:
    lens: np.ndarray          # canonical doc lengths the plan was built for
    arrays: ShardArrays       # shards in canonical doc-id space
    comm_style: str


class PlanCache:
    """Memoizes ``planner(doc_lens, num_workers)`` across packed sequences."""

    def __init__(self, planner: str | RegisteredPlanner, num_workers: int,
                 *, granularity: int = 1, max_entries: int = 1024,
                 planner_kwargs: dict | None = None):
        self.planner = get_planner(planner) if isinstance(planner, str) \
            else planner
        self.num_workers = int(num_workers)
        self.granularity = max(int(granularity), 1)
        self.max_entries = int(max_entries)
        self.planner_kwargs = dict(planner_kwargs or {})
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._lock = threading.Lock()

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
        canonical = lens[perm]
        g = self.granularity
        q = canonical if g == 1 else -(-canonical // g) * g
        key = (self.planner.info.name, self.num_workers, int(lens.sum()),
               q.tobytes())
        return key, perm

    # ------------------------------------------------------------------ #
    def plan(self, doc_lens) -> ShardingPlan:
        lens = np.asarray(doc_lens, dtype=np.int64)
        key, perm = self.signature(lens)
        canonical = lens[perm]

        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is not None:
            if np.array_equal(entry.lens, canonical):
                with self._lock:
                    self.stats.hits += 1
                return self._materialize(entry.arrays, lens, perm,
                                         entry.comm_style)
            adapted = self._adapt(entry, canonical)
            if adapted is not None:
                with self._lock:
                    self.stats.quantized_hits += 1
                return self._materialize(adapted, lens, perm,
                                         entry.comm_style)

        # miss: run the planner on the query as-is, store canonically.
        plan = self.planner(lens, self.num_workers, **self.planner_kwargs)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        stored = ShardArrays(inv[plan.arrays.doc_id], plan.arrays.start,
                             plan.arrays.length, plan.arrays.worker)
        with self._lock:
            self.stats.misses += 1
            self._entries[key] = _Entry(lens=canonical, arrays=stored,
                                        comm_style=plan.comm_style)
            self._entries.move_to_end(key)
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

    def _adapt(self, entry: _Entry, canonical: np.ndarray
               ) -> ShardArrays | None:
        """Re-fit a cached shard layout to slightly different doc lengths.

        Per document: shard boundaries are clamped to the new length (the
        last surviving shard absorbs the difference), then the equal-token
        repair restores Eq. 2 if the planner requires it.  Returns None if
        the adapted plan fails validation: the caller re-plans.
        """
        new_total = int(canonical.sum())
        if len(entry.lens) != len(canonical) \
                or new_total % self.num_workers != 0:
            return None
        try:
            a = entry.arrays.sorted_by_doc()
            new_len_of = canonical[a.doc_id]
            start = np.minimum(a.start, new_len_of)
            end = np.minimum(a.end, new_len_of)
            # last shard of each doc (sorted order) stretches to the new end
            is_doc_last = np.ones(len(a), dtype=bool)
            if len(a) > 1:
                is_doc_last[:-1] = a.doc_id[:-1] != a.doc_id[1:]
            end = np.where(is_doc_last, new_len_of, end)
            length = end - start
            keep = length > 0
            adapted = ShardArrays(a.doc_id[keep], start[keep], length[keep],
                                  a.worker[keep])

            state = _ArrayState(self.num_workers,
                                np.zeros(self.num_workers, np.int64),
                                np.zeros(self.num_workers, np.float64),
                                canonical)
            for d, s, n, w in zip(adapted.doc_id, adapted.start,
                                  adapted.length, adapted.worker):
                state.add(int(d), int(s), int(n), int(w))
            if self.planner.info.needs_equal_tokens:
                _repair_equal_tokens(state, new_total // self.num_workers)
            out = state.to_arrays().merged()
            probe = ShardingPlan(doc_lens=canonical, arrays=out,
                                 num_workers=self.num_workers,
                                 comm_style=entry.comm_style)
            validate_plan(
                probe,
                require_equal_tokens=self.planner.info.needs_equal_tokens,
                token_tolerance=self.num_workers)
            return out
        except (AssertionError, RuntimeError):
            return None
