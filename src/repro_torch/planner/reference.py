"""Frozen seed implementations of the FlashCP planning stack (the port's
copy of the reference's golden specification, kept loop for loop).

This module is a self-contained, loop-based copy of the original (pre-SoA)
planner code: the ``Shard``-object data structures, Algorithm 1, the three
baselines, and the plan encoder.  It exists for two reasons:

* **golden parity** — ``tests/test_torch_planner_reference.py`` asserts
  that this copy equals the reference's bit for bit, and that the
  vectorized planners in :mod:`repro_torch.planner` emit shard-for-shard
  identical plans to it across seeds, datasets, and CP sizes;
* **speedup accounting** — a planner benchmark times this code as the
  baseline for the planning+encoding speedup it reports.

Do not "optimize" this file; it is the specification the fast path is
checked against.  Production code must import from
:mod:`repro_torch.planner`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "RefShard",
    "RefShardingPlan",
    "ref_flashcp_plan",
    "ref_llama3_plan",
    "ref_per_doc_plan",
    "ref_ring_zigzag_plan",
    "ref_contiguous_plan",
    "ref_encode_plan",
    "ref_encode_plan_batch",
    "REFERENCE_PLANNERS",
]


def _shard_workload(prefix: int, length: int) -> float:
    return (2 * prefix + length + 1) * length / 2.0


@dataclasses.dataclass(frozen=True)
class RefShard:
    """A contiguous slice of one document, assigned to one CP worker."""

    doc_id: int
    start: int
    length: int
    worker: int

    @property
    def end(self) -> int:
        return self.start + self.length

    def is_last(self, doc_len: int) -> bool:
        return self.end == doc_len

    def workload(self) -> float:
        return _shard_workload(self.start, self.length)


@dataclasses.dataclass
class RefShardingPlan:
    doc_lens: np.ndarray
    shards: list[RefShard]
    num_workers: int
    comm_style: str = "flashcp"

    @property
    def context_len(self) -> int:
        return int(np.sum(self.doc_lens))

    @property
    def num_docs(self) -> int:
        return len(self.doc_lens)

    def tokens_per_worker(self) -> np.ndarray:
        t = np.zeros(self.num_workers, dtype=np.int64)
        for s in self.shards:
            t[s.worker] += s.length
        return t

    def workload_per_worker(self) -> np.ndarray:
        w = np.zeros(self.num_workers, dtype=np.float64)
        for s in self.shards:
            w[s.worker] += s.workload()
        return w

    def imbalance_ratio(self) -> float:
        w = self.workload_per_worker()
        avg = float(np.mean(w))
        if avg == 0.0:
            return 1.0
        return float(np.max(w)) / avg

    def nonlast_tokens_per_worker(self) -> np.ndarray:
        t = np.zeros(self.num_workers, dtype=np.int64)
        for s in self.shards:
            if not s.is_last(int(self.doc_lens[s.doc_id])):
                t[s.worker] += s.length
        return t

    def comm_tokens(self) -> int:
        if self.comm_style == "flashcp":
            return int(np.max(self.nonlast_tokens_per_worker()))
        return self.context_len // self.num_workers


def ref_validate_plan(plan: RefShardingPlan, *, require_equal_tokens=True,
                      token_tolerance: int = 0) -> None:
    by_doc: dict[int, list[RefShard]] = {}
    for s in plan.shards:
        assert s.length > 0, f"empty shard {s}"
        assert 0 <= s.worker < plan.num_workers, f"bad worker in {s}"
        assert 0 <= s.doc_id < plan.num_docs, f"bad doc_id in {s}"
        by_doc.setdefault(s.doc_id, []).append(s)

    assert set(by_doc) == set(range(plan.num_docs)), "missing documents"
    for doc_id, shards in by_doc.items():
        shards = sorted(shards, key=lambda s: s.start)
        pos = 0
        for s in shards:
            assert s.start == pos
            pos = s.end
        assert pos == int(plan.doc_lens[doc_id])

    if require_equal_tokens:
        t = plan.tokens_per_worker()
        c = plan.context_len
        n = plan.num_workers
        assert c % n == 0
        assert int(t.max() - c // n) <= token_tolerance \
            and int(c // n - t.min()) <= token_tolerance


def ref_merge_adjacent_shards(shards: Iterable[RefShard]) -> list[RefShard]:
    out: list[RefShard] = []
    for s in sorted(shards, key=lambda s: (s.doc_id, s.start)):
        if out and out[-1].doc_id == s.doc_id and out[-1].end == s.start \
                and out[-1].worker == s.worker:
            prev = out.pop()
            s = RefShard(s.doc_id, prev.start, prev.length + s.length,
                         s.worker)
        out.append(s)
    return out


# --------------------------------------------------------------------- #
# Algorithm 1 (seed implementation)
# --------------------------------------------------------------------- #
def ref_zigzag_doc_shards(doc_id: int, doc_len: int,
                          num_workers: int) -> list[RefShard]:
    n2 = 2 * num_workers
    base, rem = divmod(doc_len, n2)
    sizes = [base + (1 if c < rem else 0) for c in range(n2)]
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    shards = []
    for c in range(n2):
        if sizes[c] == 0:
            continue
        worker = c if c < num_workers else n2 - 1 - c
        shards.append(RefShard(doc_id=doc_id, start=int(starts[c]),
                               length=int(sizes[c]), worker=worker))
    return ref_merge_adjacent_shards(shards)


@dataclasses.dataclass
class _Piece:
    doc_id: int
    start: int
    length: int
    worker: int

    @property
    def end(self) -> int:
        return self.start + self.length

    def workload(self) -> float:
        return _shard_workload(self.start, self.length)


class _State:
    def __init__(self, num_workers, base_tokens, base_workload, doc_lens=None):
        self.N = num_workers
        self.pieces: list[_Piece] = []
        self.tokens = np.asarray(base_tokens, dtype=np.int64).copy()
        self.work = np.asarray(base_workload, dtype=np.float64).copy()
        self.doc_lens = doc_lens

    def is_last(self, piece: _Piece) -> bool:
        if self.doc_lens is None:
            return True
        return piece.end == int(self.doc_lens[piece.doc_id])

    def add(self, piece: _Piece) -> None:
        self.pieces.append(piece)
        self.tokens[piece.worker] += piece.length
        self.work[piece.worker] += piece.workload()

    def move(self, piece: _Piece, worker: int) -> None:
        self.tokens[piece.worker] -= piece.length
        self.work[piece.worker] -= piece.workload()
        piece.worker = worker
        self.tokens[worker] += piece.length
        self.work[worker] += piece.workload()

    def cut_head(self, piece: _Piece, size: int, receiver: int) -> _Piece:
        assert 0 < size < piece.length
        donor = piece.worker
        head = _Piece(piece.doc_id, piece.start, size, receiver)
        old_w = piece.workload()
        piece.start += size
        piece.length -= size
        self.tokens[donor] -= size
        self.work[donor] += piece.workload() - old_w
        self.add(head)
        return head

    def cut_tail(self, piece: _Piece, size: int, receiver: int) -> _Piece:
        assert 0 < size < piece.length
        donor = piece.worker
        tail = _Piece(piece.doc_id, piece.end - size, size, receiver)
        old_w = piece.workload()
        piece.length -= size
        self.tokens[donor] -= size
        self.work[donor] += piece.workload() - old_w
        self.add(tail)
        return tail


def _repair_equal_tokens(state: _State, target: int) -> None:
    guard = 0
    while True:
        guard += 1
        if guard > 100_000:  # pragma: no cover
            raise RuntimeError("token repair failed to converge")
        excess = state.tokens - target
        donor = int(np.argmax(excess))
        receiver = int(np.argmin(excess))
        if excess[donor] <= 0:
            assert np.all(excess == 0), f"tokens drifted: {state.tokens}"
            return
        need = int(min(excess[donor], -excess[receiver]))
        assert need > 0

        donor_pieces = [p for p in state.pieces if p.worker == donor]
        if not donor_pieces:
            return
        fits = [p for p in donor_pieces if p.length <= need]
        if fits:
            best = max(fits, key=lambda p: p.length)
            state.move(best, receiver)
            continue

        candidates = [p for p in donor_pieces if p.length > need]
        assert candidates, "no piece can donate a cut"
        gap = state.work[donor] - state.work[receiver]

        def added_comm(p: _Piece) -> int:
            if not state.is_last(p):
                return 0
            return min(need, p.length - need)

        def level_score(p: _Piece) -> float:
            if state.is_last(p) and need > p.length - need:
                moved = _shard_workload(p.end - need, need)
            else:
                moved = _shard_workload(p.start, need)
            return abs(gap - 2.0 * moved)

        best = min(candidates, key=lambda p: (added_comm(p), level_score(p)))
        if state.is_last(best) and need > best.length - need:
            state.cut_tail(best, need, receiver)
        else:
            state.cut_head(best, need, receiver)


def _workload_exchange(state: _State, target_tokens: int,
                       target_ratio: float, max_iters: int = 40) -> None:
    for _ in range(max_iters):
        work = state.work
        mean = float(np.mean(work))
        if mean <= 0 or float(np.max(work)) / mean <= target_ratio:
            return
        hot = int(np.argmax(work))
        cold = int(np.argmin(work))
        hot_pieces = [p for p in state.pieces if p.worker == hot]
        cold_pieces = [p for p in state.pieces if p.worker == cold]
        if not hot_pieces:
            return
        gap = work[hot] - work[cold]

        best = None
        for A in hot_pieces:
            wa = A.workload()
            for B in cold_pieces + [None]:
                wb = B.workload() if B is not None else 0.0
                delta = wa - wb
                if delta <= 0 or delta >= gap:
                    continue
                score = abs(gap - 2 * delta)
                if best is None or score < best[0]:
                    best = (score, A, B)
        if best is None:
            return
        _, A, B = best
        state.move(A, cold)
        if B is not None:
            state.move(B, hot)
        _repair_equal_tokens(state, target_tokens)


def ref_flashcp_plan(doc_lens: Sequence[int], num_workers: int, *,
                     target_ratio: float = 1.05,
                     max_outer_iters: int | None = None,
                     validate: bool = True) -> RefShardingPlan:
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    n = len(doc_lens)
    ctx = int(doc_lens.sum())
    N = num_workers
    assert ctx % N == 0
    per_worker = ctx // N
    if max_outer_iters is None:
        max_outer_iters = n + 1

    order = sorted(range(n), key=lambda i: (-int(doc_lens[i]), i))

    per_doc_ids: list[int] = []
    remaining: list[int] = list(order)

    state: _State | None = None
    outer = 0
    while True:
        outer += 1
        base_tokens = np.zeros(N, dtype=np.int64)
        base_work = np.zeros(N, dtype=np.float64)
        per_doc_shards: list[RefShard] = []
        n2 = 2 * N
        for did in per_doc_ids:
            d = int(doc_lens[did])
            base, rem = divmod(d, n2)
            sizes = [base] * n2
            worker_of = [c if c < N else n2 - 1 - c for c in range(n2)]
            if rem:
                chunk_order = sorted(
                    range(n2),
                    key=lambda c: (base_tokens[worker_of[c]], c))
                for c in chunk_order[:rem]:
                    sizes[c] += 1
            starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
            chunk_shards = [
                RefShard(did, int(starts[c]), int(sizes[c]), worker_of[c])
                for c in range(n2) if sizes[c] > 0]
            for s in ref_merge_adjacent_shards(chunk_shards):
                per_doc_shards.append(s)
                base_tokens[s.worker] += s.length
                base_work[s.worker] += s.workload()

        state = _State(N, base_tokens, base_work, doc_lens)
        for did in remaining:
            j = int(np.argmin(state.work))
            state.add(_Piece(did, 0, int(doc_lens[did]), j))

        _repair_equal_tokens(state, per_worker)
        _workload_exchange(state, per_worker, target_ratio)

        work = state.work
        cur_ratio = float(np.max(work)) / max(float(np.mean(work)), 1e-9)

        if cur_ratio <= target_ratio or not remaining \
                or outer >= max_outer_iters:
            break
        per_doc_ids.append(remaining.pop(0))

    shards = list(per_doc_shards)
    shards.extend(
        RefShard(p.doc_id, p.start, p.length, p.worker) for p in state.pieces
    )
    shards = ref_merge_adjacent_shards(shards)
    plan = RefShardingPlan(doc_lens=doc_lens, shards=shards, num_workers=N,
                           comm_style="flashcp")
    if validate:
        ref_validate_plan(plan, token_tolerance=0 if not per_doc_ids else N)
    return plan


# --------------------------------------------------------------------- #
# baselines (seed implementations)
# --------------------------------------------------------------------- #
def _doc_bounds(doc_lens: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(doc_lens)])


def ref_llama3_plan(doc_lens, num_workers, *, validate=True) -> RefShardingPlan:
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    ctx = int(doc_lens.sum())
    n2 = 2 * num_workers
    assert ctx % n2 == 0
    chunk = ctx // n2
    bounds = _doc_bounds(doc_lens)

    shards: list[RefShard] = []
    for c in range(n2):
        worker = c if c < num_workers else n2 - 1 - c
        lo, hi = c * chunk, (c + 1) * chunk
        first = int(np.searchsorted(bounds, lo, side="right")) - 1
        pos = lo
        d = first
        while pos < hi:
            doc_end = int(bounds[d + 1])
            take = min(hi, doc_end) - pos
            shards.append(RefShard(doc_id=d, start=int(pos - bounds[d]),
                                   length=int(take), worker=worker))
            pos += take
            d += 1
    shards = ref_merge_adjacent_shards(shards)
    plan = RefShardingPlan(doc_lens=doc_lens, shards=shards,
                           num_workers=num_workers, comm_style="allgather")
    if validate:
        ref_validate_plan(plan)
    return plan


def ref_per_doc_plan(doc_lens, num_workers, *, validate=True) -> RefShardingPlan:
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    shards: list[RefShard] = []
    for did, d in enumerate(doc_lens):
        shards.extend(ref_zigzag_doc_shards(did, int(d), num_workers))
    plan = RefShardingPlan(doc_lens=doc_lens, shards=shards,
                           num_workers=num_workers, comm_style="allgather")
    if validate:
        ref_validate_plan(plan, require_equal_tokens=False)
    return plan


def ref_ring_zigzag_plan(doc_lens, num_workers, *, validate=True):
    plan = ref_per_doc_plan(doc_lens, num_workers, validate=validate)
    plan.comm_style = "ring"
    return plan


def ref_contiguous_plan(doc_lens, num_workers, *, validate=True):
    doc_lens = np.asarray(doc_lens, dtype=np.int64)
    ctx = int(doc_lens.sum())
    assert ctx % num_workers == 0
    chunk = ctx // num_workers
    bounds = _doc_bounds(doc_lens)

    shards: list[RefShard] = []
    for j in range(num_workers):
        lo, hi = j * chunk, (j + 1) * chunk
        first = int(np.searchsorted(bounds, lo, side="right")) - 1
        pos, d = lo, first
        while pos < hi:
            doc_end = int(bounds[d + 1])
            take = min(hi, doc_end) - pos
            shards.append(RefShard(doc_id=d, start=int(pos - bounds[d]),
                                   length=int(take), worker=j))
            pos += take
            d += 1
    shards = ref_merge_adjacent_shards(shards)
    plan = RefShardingPlan(doc_lens=doc_lens, shards=shards,
                           num_workers=num_workers, comm_style="flashcp")
    if validate:
        ref_validate_plan(plan)
    return plan


# --------------------------------------------------------------------- #
# plan encoding (seed implementation)
# --------------------------------------------------------------------- #
def _next_pow2(x: int, floor: int = 128) -> int:
    v = floor
    while v < x:
        v *= 2
    return v


def _pick_buffer_bucket(comm_tokens: int, t_loc: int, floor: int = 128) -> int:
    return min(_next_pow2(max(comm_tokens, 1), floor),
               _next_pow2(t_loc, floor))


@dataclasses.dataclass
class RefPlanEncoding:
    perm: np.ndarray
    doc: np.ndarray
    pos: np.ndarray
    send_idx: np.ndarray
    gath_doc: np.ndarray
    gath_pos: np.ndarray
    t_loc: int
    buf_len: int
    comm_tokens: int
    imbalance: float


def ref_encode_plan(plan: RefShardingPlan, *, buf_len=None, t_loc=None,
                    align: int = 1) -> RefPlanEncoding:
    N = plan.num_workers
    doc_starts = np.concatenate([[0], np.cumsum(plan.doc_lens)])[:-1]

    per_worker: list[list[RefShard]] = [[] for _ in range(N)]
    for s in plan.shards:
        per_worker[s.worker].append(s)
    for j in range(N):
        per_worker[j].sort(key=lambda s: (s.doc_id, s.start))

    tokens_per_worker = [sum(s.length for s in ws) for ws in per_worker]
    need_t = max(tokens_per_worker)
    if t_loc is None:
        t_loc = need_t
        if align > 1:
            t_loc = ((t_loc + align - 1) // align) * align
    assert t_loc >= need_t, (t_loc, need_t)

    C_pad = N * t_loc
    perm = np.full(C_pad, -1, np.int64)
    doc = np.full(C_pad, -1, np.int32)
    pos = np.zeros(C_pad, np.int32)

    send_lists: list[np.ndarray] = []
    for j, ws in enumerate(per_worker):
        cursor = j * t_loc
        send_local: list[np.ndarray] = []
        for s in ws:
            rng = np.arange(s.start, s.end)
            perm[cursor: cursor + s.length] = doc_starts[s.doc_id] + rng
            doc[cursor: cursor + s.length] = s.doc_id
            pos[cursor: cursor + s.length] = rng
            if not s.is_last(int(plan.doc_lens[s.doc_id])):
                base = cursor - j * t_loc
                send_local.append(np.arange(base, base + s.length))
            cursor += s.length
        send_lists.append(
            np.concatenate(send_local) if send_local
            else np.zeros(0, np.int64))

    max_send = max((len(s) for s in send_lists), default=0)
    if buf_len is None:
        buf_len = _pick_buffer_bucket(max_send, t_loc)
    assert buf_len >= max_send

    send_idx = np.full((N, buf_len), -1, np.int32)
    gath_doc = np.full(N * buf_len, -1, np.int32)
    gath_pos = np.zeros(N * buf_len, np.int32)
    for j, sl in enumerate(send_lists):
        send_idx[j, : len(sl)] = sl
        gath_doc[j * buf_len: j * buf_len + len(sl)] = doc[j * t_loc + sl]
        gath_pos[j * buf_len: j * buf_len + len(sl)] = pos[j * t_loc + sl]

    return RefPlanEncoding(
        perm=perm, doc=doc, pos=pos, send_idx=send_idx,
        gath_doc=gath_doc, gath_pos=gath_pos, t_loc=t_loc, buf_len=buf_len,
        comm_tokens=max_send, imbalance=plan.imbalance_ratio())


def ref_encode_plan_batch(plans, *, buf_len=None, align: int = 1):
    N = plans[0].num_workers
    assert all(p.num_workers == N for p in plans)

    pre = [ref_encode_plan(p, buf_len=None, align=align) for p in plans]
    t_loc = max(e.t_loc for e in pre)
    if buf_len is None:
        buf_len = max(e.buf_len for e in pre)
    encs = [ref_encode_plan(p, buf_len=buf_len, t_loc=t_loc) for p in plans]

    stack = {
        "perm": np.stack([e.perm for e in encs]),
        "doc": np.stack([e.doc for e in encs]).astype(np.int32),
        "pos": np.stack([e.pos for e in encs]).astype(np.int32),
        "send_idx": np.stack([e.send_idx for e in encs]).astype(np.int32),
        "gath_doc": np.stack([e.gath_doc for e in encs]).astype(np.int32),
        "gath_pos": np.stack([e.gath_pos for e in encs]).astype(np.int32),
    }
    return stack, encs


def _ref_flashcp_adapter(doc_lens, num_workers, *, validate=True):
    return ref_flashcp_plan(doc_lens, num_workers, validate=validate)


REFERENCE_PLANNERS = {
    "llama3": ref_llama3_plan,
    "per_doc": ref_per_doc_plan,
    "ring_zigzag": ref_ring_zigzag_plan,
    "ring": ref_ring_zigzag_plan,
    "contiguous": ref_contiguous_plan,
    "flashcp": _ref_flashcp_adapter,
}
