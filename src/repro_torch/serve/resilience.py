"""Serving resilience: bounded admission and fault quarantine.

The port's copy of the admission policy and the watchdog of the
reference (DESIGN.md §Serving-resilience):

* **Bounded admission with deadline-aware shedding** —
  :class:`AdmissionConfig` caps the queue and picks the overload
  policy: ``"fifo"`` sheds the *incoming* request when the queue is
  full, ``"deadline"`` sheds the queued-or-incoming request least
  likely to meet its deadline (lowest ``(priority, slack)``) and drops
  queued requests whose deadline became unmeetable.  ``lookahead`` lets
  up to that many requests jump a head that cannot be placed right now,
  under a starvation guard.
* **Fault quarantine** (:class:`Watchdog`) — planned-but-no-progress
  slots are aborted after ``stall_patience`` steps; the engine aborts
  requests with non-finite logits.  Per-request keyed sampling keeps
  the healthy requests' tokens unchanged.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["AdmissionConfig", "Watchdog", "deadline_slack",
           "estimate_steps", "shed_key"]


# ------------------------------------------------------------------- #
# admission policy
# ------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Queue bound + overload policy for :class:`~.scheduler.Scheduler`.

    ``max_queue=0`` keeps the queue unbounded (the pre-resilience
    behavior).  ``lookahead=0`` is strict FIFO admission: a head that
    cannot be placed blocks everything behind it."""
    max_queue: int = 0
    policy: str = "fifo"            # "fifo" | "deadline"
    lookahead: int = 0              # requests that may jump a blocked head
    starvation_limit: int = 8       # head jumps before look-ahead pauses

    def __post_init__(self):
        if self.policy not in ("fifo", "deadline"):
            raise ValueError(f"unknown admission policy {self.policy!r}")


def estimate_steps(prompt_len: int, max_new: int, prefill_chunk: int) -> int:
    """Optimistic engine-step lower bound to serve a queued request:
    one step per prompt chunk (the final chunk also yields the first
    token) plus one decode step per remaining token.  Optimistic on
    purpose — shedding on it never sheds a request that could still
    have met its deadline under ideal scheduling."""
    chunks = -(-prompt_len // max(prefill_chunk, 1))
    return chunks + max(max_new - 1, 0)


def deadline_slack(req, clock: int, prefill_chunk: int) -> float:
    """Engine steps to spare before ``req``'s deadline becomes
    unmeetable even if admitted *now* (+inf when no deadline)."""
    if req.deadline_steps < 0:
        return math.inf
    due = req.submit_step + req.deadline_steps
    return due - clock - estimate_steps(req.prompt_len, req.max_new,
                                        prefill_chunk)


def shed_key(req, clock: int, prefill_chunk: int):
    """Shed order under overload: lowest priority first, then least
    slack, then newest arrival (highest rid) as the tie-break."""
    return (req.priority, deadline_slack(req, clock, prefill_chunk),
            -req.rid)


# ------------------------------------------------------------------- #
# fault quarantine
# ------------------------------------------------------------------- #
class Watchdog:
    """Per-slot no-progress detector.  A slot counts as *stalled* only
    on steps where the scheduler planned work for it (prefill chunk or
    decode token) and none landed — budget starvation and serial-mode
    waits plan nothing and so can never trip it.  ``stall_patience``
    consecutive stalled steps abort the slot's request."""

    def __init__(self, stall_patience: int = 8):
        self.stall_patience = stall_patience
        self._stalled: dict[int, int] = {}

    def observe(self, planned: set[int], progressed: set[int],
                ) -> list[tuple[int, int]]:
        """Returns ``[(slot, consecutive_stalled_steps)]`` for slots
        that just hit the patience limit."""
        out = []
        for s in planned:
            if s in progressed:
                self._stalled.pop(s, None)
                continue
            c = self._stalled.get(s, 0) + 1
            self._stalled[s] = c
            if c >= self.stall_patience:
                out.append((s, c))
        return out

    def clear(self, slot: int) -> None:
        self._stalled.pop(slot, None)
