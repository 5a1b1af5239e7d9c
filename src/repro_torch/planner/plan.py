"""Sharding-plan data structures for FlashCP context parallelism.

Terminology follows the paper (§3.1):

* A packed input sequence of context length ``C`` contains ``n`` documents
  ``D = [d_1 .. d_n]`` (lengths).
* Documents are partitioned into ``m`` shards ``S = [s_1 .. s_m]``; shard
  ``i`` has a *prefix length* ``p_i`` — the number of tokens of the same
  document preceding its start.
* Each shard is assigned to exactly one CP worker (Eq. 1); every worker holds
  exactly ``C / N`` tokens (Eq. 2, the equal-token constraint).
* A shard is a **last shard** iff it contains the final token of its
  document.  Only *non-last* shards ever need their KV communicated (§3.2).

The canonical shard storage is :class:`ShardArrays` — a structure-of-arrays
(doc_id / start / length / worker as int64 numpy arrays).  Every derived
quantity (token counts, attention workload, the Eq. 5 communication term,
plan validation) is a handful of vectorized numpy ops instead of a Python
loop over thousands of ``Shard`` objects, which is what makes host-side
planning+encoding at C = 131072 cheap enough to sit on the training input
path.  ``Shard`` objects remain available as a view for tests, debugging,
and small-scale manipulation.

Everything in this module is host-side ``numpy`` / pure Python; the
device-facing encoding lives in :mod:`repro_torch.planner.encode`.
The port's copy of the reference's ``repro.planner.plan``, held against
it bit for bit by ``tests/test_torch_planner.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Shard",
    "ShardArrays",
    "ShardingPlan",
    "make_whole_doc_plan",
    "validate_plan",
    "merge_adjacent_shards",
    "shard_workload_array",
]


def shard_workload_array(prefix, length):
    """Vectorized W_i = (2 p_i + s_i + 1) * s_i / 2 (paper §3.1).

    Exact in float64 for any context length that fits a training window:
    every workload is a multiple of 0.5 well below 2**53.
    """
    prefix = np.asarray(prefix, dtype=np.int64)
    length = np.asarray(length, dtype=np.int64)
    return (2 * prefix + length + 1) * length / 2.0


@dataclasses.dataclass(frozen=True)
class Shard:
    """A contiguous slice of one document, assigned to one CP worker."""

    doc_id: int
    start: int      # offset inside the document == prefix length p_i
    length: int     # s_i, in tokens
    worker: int

    @property
    def end(self) -> int:
        return self.start + self.length

    def is_last(self, doc_len: int) -> bool:
        return self.end == doc_len

    def workload(self) -> float:
        """Attention workload W_i = (2 p_i + s_i + 1) * s_i / 2 (paper §3.1)."""
        return (2 * self.start + self.length + 1) * self.length / 2.0


class ShardArrays:
    """Structure-of-arrays shard storage: four parallel int64 arrays."""

    __slots__ = ("doc_id", "start", "length", "worker")

    def __init__(self, doc_id, start, length, worker):
        self.doc_id = np.asarray(doc_id, dtype=np.int64)
        self.start = np.asarray(start, dtype=np.int64)
        self.length = np.asarray(length, dtype=np.int64)
        self.worker = np.asarray(worker, dtype=np.int64)

    # ------------------------------------------------------------------ #
    @classmethod
    def empty(cls) -> "ShardArrays":
        z = np.zeros(0, np.int64)
        return cls(z, z.copy(), z.copy(), z.copy())

    @classmethod
    def from_shards(cls, shards: Iterable[Shard]) -> "ShardArrays":
        shards = list(shards)
        if not shards:
            return cls.empty()
        return cls([s.doc_id for s in shards], [s.start for s in shards],
                   [s.length for s in shards], [s.worker for s in shards])

    @classmethod
    def concatenate(cls, parts: Sequence["ShardArrays"]) -> "ShardArrays":
        parts = [p for p in parts if len(p)]
        if not parts:
            return cls.empty()
        return cls(np.concatenate([p.doc_id for p in parts]),
                   np.concatenate([p.start for p in parts]),
                   np.concatenate([p.length for p in parts]),
                   np.concatenate([p.worker for p in parts]))

    def __len__(self) -> int:
        return len(self.doc_id)

    def copy(self) -> "ShardArrays":
        return ShardArrays(self.doc_id.copy(), self.start.copy(),
                           self.length.copy(), self.worker.copy())

    def to_shards(self) -> list[Shard]:
        return [Shard(int(d), int(s), int(l), int(w))
                for d, s, l, w in zip(self.doc_id, self.start,
                                      self.length, self.worker)]

    # ------------------------------------------------------------------ #
    @property
    def end(self) -> np.ndarray:
        return self.start + self.length

    def workload(self) -> np.ndarray:
        return shard_workload_array(self.start, self.length)

    def is_last(self, doc_lens: np.ndarray) -> np.ndarray:
        return self.end == np.asarray(doc_lens, np.int64)[self.doc_id]

    def tokens_per_worker(self, num_workers: int) -> np.ndarray:
        return np.bincount(self.worker, weights=self.length,
                           minlength=num_workers).astype(np.int64)

    def workload_per_worker(self, num_workers: int) -> np.ndarray:
        return np.bincount(self.worker, weights=self.workload(),
                           minlength=num_workers)

    def nonlast_tokens_per_worker(self, doc_lens, num_workers: int
                                  ) -> np.ndarray:
        nonlast = ~self.is_last(doc_lens)
        return np.bincount(self.worker[nonlast],
                           weights=self.length[nonlast],
                           minlength=num_workers).astype(np.int64)

    # ------------------------------------------------------------------ #
    def sorted_by_doc(self) -> "ShardArrays":
        """Canonical (doc_id, start) order."""
        order = np.lexsort((self.start, self.doc_id))
        return self._take(order)

    def _take(self, idx) -> "ShardArrays":
        return ShardArrays(self.doc_id[idx], self.start[idx],
                           self.length[idx], self.worker[idx])

    def merged(self) -> "ShardArrays":
        """Merge shards of the same doc that are adjacent *and* co-located.

        Returns a new ShardArrays in canonical (doc_id, start) order — the
        vectorized equivalent of the seed's ``merge_adjacent_shards``.
        """
        if len(self) == 0:
            return ShardArrays.empty()
        a = self.sorted_by_doc()
        new_run = np.ones(len(a), dtype=bool)
        new_run[1:] = ((a.doc_id[1:] != a.doc_id[:-1])
                       | (a.start[1:] != a.end[:-1])
                       | (a.worker[1:] != a.worker[:-1]))
        starts_idx = np.nonzero(new_run)[0]
        length = np.add.reduceat(a.length, starts_idx)
        return ShardArrays(a.doc_id[starts_idx], a.start[starts_idx],
                           length, a.worker[starts_idx])


class ShardingPlan:
    """A complete sharding + distribution plan for one packed sequence.

    Backed by a :class:`ShardArrays`; the ``shards`` attribute materializes
    ``Shard`` objects lazily for compatibility with object-oriented callers.
    """

    def __init__(self, doc_lens, shards: list[Shard] | None = None,
                 num_workers: int | None = None,
                 comm_style: str = "flashcp",
                 arrays: ShardArrays | None = None):
        self.doc_lens = np.asarray(doc_lens, dtype=np.int64)
        assert num_workers is not None, "num_workers is required"
        self.num_workers = int(num_workers)
        # how KV is exchanged at execution time; informs cost models and the
        # device-side executor.  "flashcp" = sharding-aware compact
        # all-gather (Eq. 5); "allgather" = full-KV all-gather (Eq. 4,
        # Llama3/Per-Doc CP); "ring" = P2P ring exchange of full KV.
        self.comm_style = comm_style
        if arrays is None:
            arrays = ShardArrays.from_shards(shards or [])
        self.arrays = arrays
        self._shards: list[Shard] | None = \
            list(shards) if shards is not None else None

    # ------------------------------------------------------------------ #
    @property
    def shards(self) -> list[Shard]:
        if self._shards is None:
            self._shards = self.arrays.to_shards()
        return self._shards

    @property
    def context_len(self) -> int:
        return int(np.sum(self.doc_lens))

    @property
    def num_docs(self) -> int:
        return len(self.doc_lens)

    def shards_of_worker(self, j: int) -> list[Shard]:
        return self.arrays._take(self.arrays.worker == j).to_shards()

    def tokens_per_worker(self) -> np.ndarray:
        return self.arrays.tokens_per_worker(self.num_workers)

    def workload_per_worker(self) -> np.ndarray:
        return self.arrays.workload_per_worker(self.num_workers)

    def imbalance_ratio(self) -> float:
        """max_workload / avg_workload across CP workers (paper §4.3)."""
        w = self.workload_per_worker()
        avg = float(np.mean(w)) if len(w) else 0.0
        if avg == 0.0:
            return 1.0
        return float(np.max(w)) / avg

    # ------------------------------------------------------------------ #
    # communication (token counts; multiply by 4*H*D*(N-1) for bytes —
    # see the reference's repro.core.workload)
    # ------------------------------------------------------------------ #
    def nonlast_tokens_per_worker(self) -> np.ndarray:
        """Σ_{i∈Ŝ} x_ij s_i for each worker j — the Eq. 5 inner term."""
        return self.arrays.nonlast_tokens_per_worker(self.doc_lens,
                                                     self.num_workers)

    def comm_tokens(self) -> int:
        """Tokens each rank contributes to the KV exchange on the critical
        path.  For the sharding-aware scheme this is Eq. 5's max-term; for
        static schemes it is the full local KV, C / N (Eq. 4)."""
        if self.comm_style == "flashcp":
            return int(np.max(self.nonlast_tokens_per_worker()))
        return self.context_len // self.num_workers

    # ------------------------------------------------------------------ #
    def sorted_shards(self) -> list[Shard]:
        a = self.arrays
        order = np.lexsort((a.start, a.doc_id, a.worker))
        return a._take(order).to_shards()

    def describe(self) -> str:
        t = self.tokens_per_worker()
        w = self.workload_per_worker()
        lines = [
            f"ShardingPlan(N={self.num_workers}, C={self.context_len}, "
            f"docs={self.num_docs}, shards={len(self.arrays)}, "
            f"comm={self.comm_style})",
            f"  tokens/worker   : {t.tolist()}",
            f"  workload/worker : {[int(x) for x in w]}",
            f"  imbalance ratio : {self.imbalance_ratio():.4f}",
            f"  comm tokens     : {self.comm_tokens()} "
            f"(static would be {self.context_len // self.num_workers})",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# constructors & checks
# ---------------------------------------------------------------------- #
def make_whole_doc_plan(
    doc_lens: Sequence[int], assignment: Sequence[int], num_workers: int
) -> ShardingPlan:
    """Plan in which every document is kept whole on ``assignment[i]``."""
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    arrays = ShardArrays(np.arange(len(doc_lens)),
                         np.zeros(len(doc_lens), np.int64),
                         doc_lens.copy(),
                         np.asarray(assignment, np.int64))
    return ShardingPlan(doc_lens=doc_lens, arrays=arrays,
                        num_workers=num_workers)


def validate_plan(plan: ShardingPlan, *, require_equal_tokens: bool = True,
                  token_tolerance: int = 0) -> None:
    """Raise ``AssertionError`` unless the plan is well formed.

    Invariants (tested property-style in tests/test_planner.py):
      * shards of each document tile [0, d_i) exactly, without overlap;
      * every shard has positive length and a valid worker id;
      * (optionally) Eq. 2 — every worker holds C/N tokens, within
        ``token_tolerance`` (zigzag chunk remainders can leave a few
        tokens of slack, absorbed by execution-side padding).
    """
    a = plan.arrays.sorted_by_doc()
    assert np.all(a.length > 0), \
        f"empty shard at doc {a.doc_id[a.length <= 0][:1]}"
    assert np.all((a.worker >= 0) & (a.worker < plan.num_workers)), \
        "bad worker id"
    assert np.all((a.doc_id >= 0) & (a.doc_id < plan.num_docs)), \
        "bad doc_id"

    present = np.unique(a.doc_id)
    assert len(present) == plan.num_docs and \
        (len(present) == 0 or (present == np.arange(plan.num_docs)).all()), \
        "missing documents"

    # tiling: within each doc, start == previous end; doc-first shard
    # starts at 0; doc-last shard ends at the document length.
    if len(a):
        doc_change = np.ones(len(a), dtype=bool)
        doc_change[1:] = a.doc_id[1:] != a.doc_id[:-1]
        first_idx = np.nonzero(doc_change)[0]
        assert np.all(a.start[first_idx] == 0), "doc does not start at 0"
        cont = ~doc_change
        assert np.all(a.start[1:][cont[1:]] == a.end[:-1][cont[1:]]), \
            "gap/overlap inside a document"
        last_idx = np.concatenate([first_idx[1:] - 1, [len(a) - 1]])
        assert np.all(a.end[last_idx] == plan.doc_lens[a.doc_id[last_idx]]), \
            "document not fully covered"

    if require_equal_tokens:
        t = plan.tokens_per_worker()
        c = plan.context_len
        n = plan.num_workers
        assert c % n == 0, f"context {c} not divisible by N={n}"
        assert int(t.max() - c // n) <= token_tolerance \
            and int(c // n - t.min()) <= token_tolerance, \
            f"equal-token constraint violated: {t.tolist()}"


def merge_adjacent_shards(shards: Iterable[Shard]) -> list[Shard]:
    """Merge shards of the same doc that are adjacent *and* co-located.

    The repair loop can produce e.g. [0,a)@w and [a,b)@w; merging keeps the
    kernel's shard count (and the comm accounting) minimal.
    """
    return ShardArrays.from_shards(shards).merged().to_shards()
