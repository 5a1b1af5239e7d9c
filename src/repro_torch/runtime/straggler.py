"""Straggler detection and mitigation (the port's copy of the reference's
``repro.runtime.straggler``).

FlashCP's load balancing is itself the first line of defence (the slowest
CP worker bounds the step, §3.1) — the planner equalizes attention work
*within* a step.  This module adds the *across-step* loop:

* per-step wall-time EMA + variance tracking;
* when jitter (p95/median) exceeds ``jitter_threshold``, the monitor
  tightens the planner's target imbalance ratio R (more aggressive
  balancing buys back the straggler slack) down to ``min_target``;
* per-host step-time EMAs turn persistent slowness into *speed weights*
  (``host_speeds``) that the adaptive dispatcher feeds into its
  capacity-proportional LPT (DESIGN.md §Recovery) — a host at speed 0.5
  gets half the workload instead of bounding every step;
* a host whose speed stays below ``slow_speed`` for ``slow_patience``
  consecutive observations is reported by :meth:`slow_hosts` for
  eviction via the fault-tolerance path (hardware degradation, not
  jitter).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    window: int = 50
    jitter_threshold: float = 1.15
    min_target: float = 1.01
    max_target: float = 1.10
    #: EMA smoothing for per-host step times (higher = more reactive)
    host_alpha: float = 0.25
    #: a host below this relative speed is a persistent-straggler
    #: candidate (hardware degradation, not step jitter)
    slow_speed: float = 0.6
    #: consecutive slow observations before :meth:`slow_hosts` reports
    slow_patience: int = 5
    _times: list[float] = dataclasses.field(default_factory=list)
    target_imbalance: float = 1.05
    _host_ema: dict[int, float] = dataclasses.field(default_factory=dict)
    _slow_streak: dict[int, int] = dataclasses.field(default_factory=dict)

    def record_step(self, seconds: float) -> None:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def jitter(self) -> float:
        if len(self._times) < 10:
            return 1.0
        t = np.asarray(self._times)
        med = float(np.median(t))
        return float(np.percentile(t, 95)) / max(med, 1e-9)

    def adjusted_target(self) -> float:
        """Planner target imbalance R for the next step."""
        j = self.jitter
        if j > self.jitter_threshold:
            self.target_imbalance = max(self.min_target,
                                        self.target_imbalance * 0.98)
        elif j < 1.05:
            self.target_imbalance = min(self.max_target,
                                        self.target_imbalance * 1.005)
        return self.target_imbalance

    # ------------------------------------------------------------- #
    # per-host speed tracking (feeds the dispatcher's weighted LPT)
    # ------------------------------------------------------------- #
    def record_host_step(self, host: int, seconds: float) -> None:
        """One host's wall time for the step just finished."""
        prev = self._host_ema.get(host)
        a = self.host_alpha
        ema = seconds if prev is None else (1.0 - a) * prev + a * seconds
        self._host_ema[host] = ema
        fastest = min(self._host_ema.values())
        speed = fastest / max(ema, 1e-12)
        if speed < self.slow_speed:
            self._slow_streak[host] = self._slow_streak.get(host, 0) + 1
        else:
            self._slow_streak[host] = 0

    def host_speeds(self, hosts) -> np.ndarray:
        """Relative speed in (0, 1] per host, 1.0 = fastest observed.

        Unobserved hosts default to 1.0 (assume healthy until measured);
        the result is normalized so the fastest listed host is 1.0 —
        exactly the ``speeds`` contract of
        :func:`repro_torch.dispatch.lpt_assign`.
        """
        hosts = list(hosts)
        if not self._host_ema:
            return np.ones(len(hosts), np.float64)
        fastest = min(self._host_ema.values())
        out = np.asarray(
            [fastest / max(self._host_ema.get(h, fastest), 1e-12)
             for h in hosts], np.float64)
        return out / out.max()

    def slow_hosts(self, hosts=None) -> list[int]:
        """Hosts persistently below ``slow_speed`` — eviction candidates
        for the fault-tolerance path."""
        pool = self._slow_streak if hosts is None else \
            {h: self._slow_streak.get(h, 0) for h in hosts}
        return sorted(h for h, n in pool.items()
                      if n >= self.slow_patience)
