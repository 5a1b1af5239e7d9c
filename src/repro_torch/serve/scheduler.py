"""Token-budget scheduler: slot admission, unified prefill/decode planning.

The engine owns ``num_slots`` request slots over a shared KV store (paged
block pool or dense stripes).  Requests queue FIFO; free slots admit from
the queue head (``admit`` consults a placement callback so the engine
can refuse — pool exhaustion — without losing a request), and a slot
frees the moment its request finishes (EOS or ``max_new``).

Each engine step is planned as **one token budget** spent across pending
prefill chunks *and* decode tokens (SplitFuse-style): every decode-ready
slot gets its decode token first, and the remaining budget trickles
prompt chunks in for slots still prefilling — a long prompt never stalls
in-flight decodes.  ``unified=False`` restores the serial discipline
(drain all pending prefill before any decode) as the stall baseline the
serve bench measures against.

Resilience (DESIGN.md §Serving-resilience): the queue is bounded and
overload sheds by deadline slack under ``AdmissionConfig``'s
``"deadline"`` policy (strict ``"fifo"`` is the parity baseline), a
blocked head can be jumped by up to ``lookahead`` placeable requests
under a starvation guard, and faults abort individual requests without
touching the rest.  Every submitted request terminates in ``finished``
with one of four statuses — ``"ok"``, ``"rejected"`` (malformed or
unplaceable), ``"shed"`` (overload victim), ``"aborted"`` (fault
quarantine or engine step cap) — so one bad request can never kill the
engine loop *and* no request is ever silently dropped.  Per-status
reason-keyed counters live in ``outcomes``.

Host-side bookkeeping only — all array work lives in the engine.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from .resilience import AdmissionConfig, deadline_slack, shed_key

__all__ = ["Request", "SlotState", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray                  # prompt token ids (Tp,) int32
    max_new: int = 16
    temperature: float = 0.0            # 0 = greedy
    top_k: int = 0                      # 0 = unrestricted
    eos_id: int = -1                    # -1 = never stops early
    # audio-frontend prompts: per-token frame embeddings (Tp, d_model);
    # ``tokens`` still carries the codec ids for bookkeeping
    frames: np.ndarray | None = None
    # resilience: engine steps from submission within which the request
    # must finish (-1 = no deadline) and its shed priority — lower
    # priority sheds first under overload
    deadline_steps: int = -1
    priority: int = 0
    # stamped by Scheduler.submit (engine-step clock + wall clock)
    submit_step: int = 0
    submit_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class SlotState:
    request: Request
    prefilled: int = 0          # prompt tokens whose KV is in cache
    length: int = 0             # tokens in cache (prompt + generated)
    generated: list[int] = dataclasses.field(default_factory=list)
    # paged layout: this request's block table (physical pool block per
    # logical block), prefix-cache hit size, and the reserved
    # copy-on-write spare for the fully-cached-prompt case
    table: list[int] = dataclasses.field(default_factory=list)
    cached_tokens: int = 0
    spare: int | None = None

    @property
    def prompt_len(self) -> int:
        return self.request.prompt_len

    @property
    def needs_prefill(self) -> bool:
        return self.prefilled < self.prompt_len

    @property
    def decode_ready(self) -> bool:
        return not self.needs_prefill and bool(self.generated)

    @property
    def done(self) -> bool:
        r = self.request
        if len(self.generated) >= r.max_new:
            return True
        return bool(self.generated) and r.eos_id >= 0 \
            and self.generated[-1] == r.eos_id


class Scheduler:
    """FIFO queue + slot table + per-step token-budget planner.

    ``token_budget`` tokens are spent per engine step (0 picks
    ``num_slots + prefill_chunk`` — every decode plus one full prompt
    chunk).  ``admit()`` pairs free slots with queued requests through a
    placement callback; ``plan_step()`` splits the budget; ``record()``
    appends decode tokens and retires finished slots.  An engine hooks
    ``on_retire(slot, state)`` to release KV blocks.

    ``admission`` bounds the queue and selects the overload policy
    (see :class:`~.resilience.AdmissionConfig`); ``clock`` is the
    engine-step counter the deadline math runs on (the engine advances
    it every step).
    """

    def __init__(self, num_slots: int, max_len: int, *,
                 prefill_chunk: int = 64, token_budget: int = 0,
                 unified: bool = True,
                 admission: AdmissionConfig | None = None):
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget or (num_slots + prefill_chunk)
        self.unified = unified
        self.admission = admission or AdmissionConfig()
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * num_slots
        self.finished: dict[int, dict[str, Any]] = {}
        self.on_retire: Callable[[int, SlotState], None] | None = None
        self.clock = 0
        # per-status, reason-keyed terminal counters (engine.stats
        # aliases these dicts — mutate in place, never rebind)
        self.outcomes: dict[str, dict[str, int]] = {
            "rejected": {}, "shed": {}, "aborted": {}}
        self.duplicates: list[dict[str, Any]] = []
        # look-ahead starvation guard: how often the current blocked
        # head has been jumped, and who that head is
        self._head_rid: int | None = None
        self._head_skips = 0

    # ------------------------------------------------------------- #
    def _count(self, status: str, kind: str) -> None:
        c = self.outcomes[status]
        c[kind] = c.get(kind, 0) + 1

    def _entry(self, req: Request, status: str, tokens,
               reason: str | None = None) -> dict[str, Any]:
        latency = self.clock - req.submit_step
        e: dict[str, Any] = {
            "status": status,
            "tokens": np.asarray(tokens, np.int32),
            "prompt_len": req.prompt_len,
            "submit_step": req.submit_step, "finish_step": self.clock,
            "latency_steps": latency,
            "latency_s": time.perf_counter() - req.submit_s,
            "deadline_steps": req.deadline_steps,
            # only a completed request can meet its deadline; goodput
            # counts (status ok) x (within deadline, if any)
            "deadline_met": status == "ok"
            and (req.deadline_steps < 0 or latency <= req.deadline_steps),
        }
        if reason is not None:
            e["reason"] = reason
        return e

    def _tracks(self, rid: int) -> bool:
        return rid in self.finished \
            or any(r.rid == rid for r in self.queue) \
            or any(st is not None and st.request.rid == rid
                   for st in self.slots)

    # ------------------------------------------------------------- #
    def submit(self, req: Request) -> bool:
        """Queue one request; malformed/oversized/overflow requests are
        recorded in ``finished`` (returns False) instead of raising — a
        bad request must not kill the engine loop.  A duplicate rid is
        refused *without* touching ``finished`` (it would clobber the
        earlier request's entry) and logged in ``duplicates``."""
        req.submit_step = self.clock
        req.submit_s = time.perf_counter()
        if self._tracks(req.rid):
            self._count("rejected", "duplicate_rid")
            self.duplicates.append({
                "rid": req.rid,
                "reason": f"duplicate rid {req.rid}: a request with this "
                          "id is already queued, active, or finished"})
            return False
        if req.prompt_len == 0:
            self.reject(req, "empty prompt", kind="empty_prompt")
        elif req.max_new <= 0:
            self.reject(req, f"non-positive max_new {req.max_new}",
                        kind="bad_max_new")
        elif req.prompt_len + req.max_new > self.max_len:
            self.reject(req, f"prompt {req.prompt_len} + max_new "
                        f"{req.max_new} exceeds max_len {self.max_len}",
                        kind="oversized")
        elif self.admission.max_queue \
                and len(self.queue) >= self.admission.max_queue:
            return self._overflow(req)
        else:
            self.queue.append(req)
            return True
        return False

    def _overflow(self, req: Request) -> bool:
        """Queue full.  FIFO policy sheds the incoming request (strict
        arrival order — the parity baseline); deadline policy sheds the
        queued-or-incoming request with the worst ``shed_key`` (lowest
        priority, then least deadline slack)."""
        if self.admission.policy != "deadline":
            self.shed(req, f"queue full ({len(self.queue)} waiting)",
                      kind="queue_full")
            return False
        victim = min([*self.queue, req],
                     key=lambda r: shed_key(r, self.clock,
                                            self.prefill_chunk))
        slack = deadline_slack(victim, self.clock, self.prefill_chunk)
        self.shed(victim, f"queue full ({len(self.queue)} waiting): "
                  f"least-slack victim (priority {victim.priority}, "
                  f"slack {slack})", kind="queue_full")
        if victim is req:
            return False
        self.queue.remove(victim)
        self.queue.append(req)
        return True

    def reject(self, req: Request, reason: str,
               kind: str = "unplaceable") -> None:
        """Record ``req`` as rejected in ``finished`` (empty tokens)."""
        self._count("rejected", kind)
        self.finished[req.rid] = self._entry(
            req, "rejected", np.zeros((0,), np.int32), reason)

    def shed(self, req: Request, reason: str, kind: str) -> None:
        """Record ``req`` as an overload-shedding victim."""
        self._count("shed", kind)
        self.finished[req.rid] = self._entry(
            req, "shed", np.zeros((0,), np.int32), reason)

    def _shed_expired(self) -> None:
        """Deadline policy: drop queued requests whose deadline is
        unmeetable even if admitted this instant (optimistic estimate —
        a shed request provably could not have finished in time)."""
        keep: deque[Request] = deque()
        while self.queue:
            r = self.queue.popleft()
            slack = deadline_slack(r, self.clock, self.prefill_chunk)
            if slack < 0:
                self.shed(r, "deadline unmeetable in queue "
                          f"(slack {slack} steps at admission)",
                          kind="deadline_expired")
            else:
                keep.append(r)
        self.queue = keep

    def admit(self, place: Callable[[Request], dict | None] | None = None,
              ) -> list[tuple[int, Request]]:
        """Fill free slots from the queue.  ``place`` reserves
        engine-side resources for a request and returns placement info
        ({"table": [...], "cached": m, "start": s, "spare": b} for the
        paged layout, {} for dense) or None — the request cannot be
        placed *now* (pool exhausted) and stays queued in order.

        With ``admission.lookahead == 0`` a blocked request stops
        admission entirely (strict FIFO: head-of-line blocking).  With
        lookahead N, up to N requests past the first blocked one are
        probed, so a small request behind a pool-hogging head still
        admits — bounded by the starvation guard: once the same head
        has been jumped ``starvation_limit`` times, look-ahead pauses
        until that head places (or sheds), so it cannot starve."""
        if self.admission.policy == "deadline":
            self._shed_expired()
        placed: list[tuple[int, Request]] = []
        free = [s for s in range(self.num_slots) if self.slots[s] is None]
        lookahead = self.admission.lookahead
        if self._head_skips >= self.admission.starvation_limit:
            lookahead = 0
        blocked: list[Request] = []
        while free and self.queue and len(blocked) <= lookahead:
            req = self.queue.popleft()
            info = place(req) if place is not None else {}
            if info is None:
                blocked.append(req)
                continue
            s = free.pop(0)
            st = SlotState(req, table=list(info.get("table", [])),
                           cached_tokens=int(info.get("cached", 0)),
                           spare=info.get("spare"))
            st.prefilled = st.length = int(info.get("start", 0))
            self.slots[s] = st
            placed.append((s, req))
        for r in reversed(blocked):
            self.queue.appendleft(r)
        # starvation accounting: the head pops first, so any placement
        # in a call where the head blocked is a jump over it
        if blocked:
            head = blocked[0]
            if head.rid != self._head_rid:
                self._head_rid, self._head_skips = head.rid, 0
            if placed:
                self._head_skips += 1
        elif self._head_rid is not None \
                and not any(r.rid == self._head_rid for r in self.queue):
            self._head_rid, self._head_skips = None, 0
        return placed

    # ------------------------------------------------------------- #
    def plan_step(self) -> tuple[list[tuple[int, int, int]], list[int]]:
        """Split this step's token budget.  Returns
        ``(prefill_items, decode_slots)`` with prefill_items =
        [(slot, start, n_tokens)].  Unified: decode-ready slots are
        funded first (one token each), the remainder buys prompt chunks.
        Serial (unified=False): all pending prefill drains before any
        decode — the stall baseline."""
        decode = [s for s in self.active_slots
                  if self.slots[s].decode_ready]
        pending = [s for s in self.active_slots
                   if self.slots[s].needs_prefill]
        if not self.unified:
            if pending:
                s = pending[0]
                st = self.slots[s]
                n = min(self.prefill_chunk, st.prompt_len - st.prefilled)
                return [(s, st.prefilled, n)], []
            return [], decode
        prefill = []
        budget = max(self.token_budget - len(decode), 0)
        for s in pending:
            if budget <= 0:
                break
            st = self.slots[s]
            n = min(self.prefill_chunk, st.prompt_len - st.prefilled,
                    budget)
            prefill.append((s, st.prefilled, n))
            budget -= n
        return prefill, decode

    def note_prefill(self, slot: int, n_tokens: int) -> None:
        """``n_tokens`` more prompt tokens entered the cache."""
        st = self.slots[slot]
        st.prefilled += n_tokens
        st.length = st.prefilled
        assert st.prefilled <= st.prompt_len, (st.prefilled, st.prompt_len)

    # ------------------------------------------------------------- #
    @property
    def active_slots(self) -> list[int]:
        return [s for s, st in enumerate(self.slots) if st is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(st is not None for st in self.slots)

    def lengths(self) -> np.ndarray:
        """Per-slot cache occupancy (0 for idle slots) — the ragged
        ``pos_t``/``lengths`` feed for the decode step."""
        return np.asarray([0 if st is None else st.length
                           for st in self.slots], np.int32)

    def active_mask(self) -> np.ndarray:
        return np.asarray([st is not None for st in self.slots], bool)

    def temperatures(self) -> np.ndarray:
        return np.asarray([0.0 if st is None else st.request.temperature
                           for st in self.slots], np.float32)

    def top_ks(self) -> np.ndarray:
        return np.asarray([0 if st is None else st.request.top_k
                           for st in self.slots], np.int32)

    def rids(self) -> np.ndarray:
        return np.asarray([0 if st is None else st.request.rid
                           for st in self.slots], np.int32)

    def sample_counts(self) -> np.ndarray:
        """Per-slot index of the *next* sample in its request's key
        stream (= tokens generated so far)."""
        return np.asarray([0 if st is None else len(st.generated)
                           for st in self.slots], np.int32)

    # ------------------------------------------------------------- #
    def start(self, slot: int, first_token: int) -> None:
        """Mark a freshly-prefilled slot: cache holds the prompt, and the
        prefill's last logits produced the first generated token."""
        st = self.slots[slot]
        st.prefilled = st.prompt_len
        st.length = max(st.length, st.prompt_len)
        st.generated.append(int(first_token))
        self._maybe_retire(slot)

    def record(self, tokens: np.ndarray, slots: list[int] | None = None,
               ) -> list[int]:
        """One decode step happened for ``slots`` (default: every
        decode-ready slot): each consumed its last token (cache grew by
        one) and sampled the next.  Returns slots retired this step."""
        if slots is None:
            slots = [s for s in self.active_slots
                     if self.slots[s].decode_ready]
        retired = []
        for s in slots:
            st = self.slots[s]
            st.length += 1
            st.generated.append(int(tokens[s]))
            if self._maybe_retire(s):
                retired.append(s)
        return retired

    def abort(self, slot: int, reason: str, kind: str = "fault") -> None:
        """Quarantine one active request: record it as ``"aborted"``
        with the tokens generated so far, release its KV (``on_retire``)
        and free the slot.  Healthy slots are untouched — per-request
        keyed sampling keeps their token streams bitwise identical."""
        st = self.slots[slot]
        assert st is not None, f"abort of idle slot {slot}"
        r = st.request
        self._count("aborted", kind)
        self.finished[r.rid] = self._entry(
            r, "aborted", np.asarray(st.generated, np.int32), reason)
        if self.on_retire is not None:
            self.on_retire(slot, st)
        self.slots[slot] = None

    def abort_all(self, reason: str, kind: str = "step_cap") -> None:
        """Abort every in-flight and queued request (engine step cap /
        shutdown): partial tokens are preserved, nothing is silently
        dropped from ``finished``."""
        for s in list(self.active_slots):
            self.abort(s, reason, kind=kind)
        while self.queue:
            r = self.queue.popleft()
            self._count("aborted", kind)
            self.finished[r.rid] = self._entry(
                r, "aborted", np.zeros((0,), np.int32),
                f"{reason} (queued, never admitted)")

    def _maybe_retire(self, slot: int) -> bool:
        st = self.slots[slot]
        if not st.done:
            return False
        gen = st.generated
        r = st.request
        if r.eos_id >= 0 and r.eos_id in gen:
            gen = gen[:gen.index(r.eos_id) + 1]
        self.finished[r.rid] = self._entry(r, "ok", gen)
        if self.on_retire is not None:
            self.on_retire(slot, st)
        self.slots[slot] = None
        return True
