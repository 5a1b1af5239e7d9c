"""Fault tolerance: failure detection + restart/elastic policy (the port's
copy of the reference's ``repro.runtime.fault_tolerance``).

The coordinator-side pieces that make thousand-node runs survivable:

* :class:`HeartbeatMonitor` — tracks per-host heartbeats; hosts silent for
  ``timeout_s`` are declared failed.  (The training CLI injects its
  failures; on a real cluster heartbeats arrive over the coordination
  service.)
* :class:`FailurePolicy` — decides between RESTART (same topology, reload
  latest checkpoint) and ELASTIC_SHRINK (drop failed hosts, rebuild the
  mesh from survivors, reshard-on-restore) based on spare capacity.
* :func:`run_with_recovery` — the supervision loop used by
  ``launch/train.py``: run the step function, catch device/runtime
  failures, apply the policy, resume from the last checkpoint with the
  deterministic data pipeline replayed to the same step.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable

__all__ = ["HeartbeatMonitor", "FailurePolicy", "FailureAction",
           "run_with_recovery", "TrainingFailure"]


class TrainingFailure(RuntimeError):
    """Raised (or injected) when a step fails due to a lost host/device."""

    def __init__(self, msg: str, failed_hosts: list[int] | None = None):
        super().__init__(msg)
        self.failed_hosts = failed_hosts or []


class FailureAction(enum.Enum):
    RESTART = "restart"              # same topology, reload checkpoint
    ELASTIC_SHRINK = "elastic_shrink"  # rebuild mesh without failed hosts
    ABORT = "abort"


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_s: float = 60.0
    _last: dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, t: float | None = None) -> None:
        self._last[host] = time.monotonic() if t is None else t

    def failed_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h in range(self.num_hosts)
                if now - self._last.get(h, -1e30) > self.timeout_s]

    def healthy(self, now: float | None = None) -> bool:
        return not self.failed_hosts(now)


@dataclasses.dataclass
class FailurePolicy:
    min_hosts: int                  # smallest mesh that still fits the model
    max_restarts: int = 10
    restarts: int = 0

    def decide(self, alive_hosts: int, failed: list[int]) -> FailureAction:
        """RESTART / ELASTIC_SHRINK / ABORT for one failure event.

        ``alive_hosts`` must be the *real* survivor count (total hosts
        minus every host lost so far) — :func:`run_with_recovery` and
        :class:`repro_torch.runtime.recovery.ElasticSupervisor` thread it
        through from the heartbeat/failure set.  The restart budget is
        charged only when a recovery attempt is actually granted; an
        ABORT verdict never burns a slot (aborting is free, retrying is
        not).
        """
        if alive_hosts < self.min_hosts:
            return FailureAction.ABORT
        if self.restarts >= self.max_restarts:
            return FailureAction.ABORT
        self.restarts += 1
        if failed:
            return FailureAction.ELASTIC_SHRINK
        return FailureAction.RESTART


def run_with_recovery(
    step_fn: Callable[[int], Any],
    *,
    start_step: int,
    total_steps: int,
    policy: FailurePolicy,
    on_restore: Callable[[FailureAction, list[int]], int],
    logger: Callable[[str], None] = print,
    num_hosts: int | None = None,
    monitor: HeartbeatMonitor | None = None,
) -> int:
    """Supervised step loop.  ``step_fn(step)`` runs one training step;
    ``on_restore(action, failed_hosts)`` reloads state (and possibly
    rebuilds the mesh), returning the step to resume from.  Returns the
    final step reached.

    The policy sees the *real* survivor count: hosts named by each
    :class:`TrainingFailure` (plus any the heartbeat ``monitor`` has
    declared dead) accumulate into a dead set, and ``alive = num_hosts -
    len(dead)`` is what :meth:`FailurePolicy.decide` judges against
    ``min_hosts``.  ``num_hosts`` defaults to the monitor's host count,
    else to ``policy.min_hosts`` (the degenerate legacy contract for
    callers that never lose hosts — alive then equals min_hosts, so
    host-less failures still RESTART).

    For degree-replanning recovery (mesh shrink + resharded restore) use
    :class:`repro_torch.runtime.recovery.ElasticSupervisor`, which layers the
    surviving-topology bookkeeping on top of this loop's semantics.
    """
    if num_hosts is None:
        num_hosts = monitor.num_hosts if monitor is not None \
            else policy.min_hosts
    step = start_step
    dead: set[int] = set()
    while step < total_steps:
        try:
            step_fn(step)
            step += 1
        except TrainingFailure as e:
            dead.update(e.failed_hosts)
            if monitor is not None:
                dead.update(monitor.failed_hosts())
            alive = num_hosts - len(dead)
            action = policy.decide(alive, e.failed_hosts)
            logger(f"[ft] step {step} failed ({e}); alive={alive}; "
                   f"action={action.value}")
            if action == FailureAction.ABORT:
                raise
            step = on_restore(action, e.failed_hosts)
    return step
