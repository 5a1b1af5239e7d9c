"""Elastic degree-replanning recovery (DESIGN.md §Recovery; the port's
copy of the reference's ``repro.runtime.recovery``).

The supervision layer that turns a lost or slow rank into a *dispatch
decision* instead of a job restart.  On a :class:`TrainingFailure` naming
failed hosts, the supervisor

1. accumulates the dead set and asks :class:`FailurePolicy` for a verdict
   against the **real** survivor count;
2. on ELASTIC_SHRINK, re-derives the surviving topology
   (:func:`replan_after_failure`): the surviving device list, the shrunk
   ``data`` axis (model/CP axis kept — it is constrained by memory and the
   CP plan, :func:`repro_torch.runtime.elastic.shrink_mesh_shape`), and the
   gradient-accumulation factor that preserves the global batch;
3. hands the plan to the training driver's ``on_restore``, which rebuilds
   the (group) mesh over the survivors, restores the latest checkpoint
   with reshard-on-load, and resumes — the data pipeline is a pure
   function of ``(seed, step)``, so the replayed stream is bit-identical
   to the resume step.

The adaptive dispatcher is the natural shrink mechanism: it already
re-tiles the mesh to any admissible CP degree per step, so recovery is
"same loop, smaller device grid".  Failure *injection* for tests/CI lives
here too (:func:`parse_fail_spec` / :class:`FailureInjector` for
``--fail-at STEP[:HOSTS]``, :func:`parse_straggle_specs` /
:class:`StragglerSim` for ``--straggle HOST:FACTOR``): the training CLI
injects failures; on a real cluster the heartbeat monitor raises the
same :class:`TrainingFailure`.  Every rank of the port's job runs the
same supervisor on the same events (the injected step, rank 0's step
time broadcast), so every rank takes the same decision.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .elastic import ElasticPlan, shrink_mesh_shape
from .fault_tolerance import (FailureAction, FailurePolicy, TrainingFailure)
from .straggler import StragglerMonitor

__all__ = ["HostTopology", "RecoveryPlan", "replan_after_failure",
           "parse_fail_spec", "parse_straggle_specs", "FailureInjector",
           "StragglerSim", "ElasticSupervisor"]


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Static host → device mapping (contiguous flat device ranges).

    Host ``h`` owns devices ``[h * devices_per_host, (h + 1) *
    devices_per_host)``: losing a host removes a contiguous range of
    devices (in the port, of ranks).
    """

    num_hosts: int
    devices_per_host: int

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    def host_of_device(self, device: int) -> int:
        return device // self.devices_per_host

    def surviving_hosts(self, dead: set[int] | list[int]) -> list[int]:
        dead = set(dead)
        return [h for h in range(self.num_hosts) if h not in dead]

    def surviving_devices(self, dead: set[int] | list[int]) -> list[int]:
        """Flat device ids owned by surviving hosts, ascending."""
        return [d for h in self.surviving_hosts(dead)
                for d in range(h * self.devices_per_host,
                               (h + 1) * self.devices_per_host)]


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """One shrink decision: everything ``on_restore`` needs to rebuild."""

    surviving_hosts: list[int]
    devices: list[int]          # surviving flat device ids
    data_axis: int              # shrunk data axis (model axis kept)
    model_axis: int
    #: grad-accumulation micro-steps preserving the global batch when the
    #: surviving devices cannot hold the old per-step batch resident
    #: (ElasticPlan.accum_factor)
    accum_factor: int
    elastic: ElasticPlan

    @property
    def n_devices(self) -> int:
        return len(self.devices)


def replan_after_failure(topology: HostTopology, dead: set[int] | list[int],
                         *, data: int, model: int) -> RecoveryPlan:
    """Derive the surviving topology after losing ``dead`` hosts.

    The model/CP axis is kept intact (the dispatcher re-derives admissible
    CP *degrees* as divisors of it on the shrunk mesh); the data axis
    shrinks to the largest power of two that fits the survivors, and
    ``accum_factor`` records the micro-batching that preserves the global
    batch.  Raises ``ValueError`` when the survivors cannot hold the
    model axis — the supervisor maps that to ABORT.
    """
    devices = topology.surviving_devices(dead)
    plan = shrink_mesh_shape(len(devices), model_axis=model,
                             old_data_axis=data)
    new_data = plan.mesh_shape[0]
    # the mesh uses the first data*model survivors (a contiguous prefix
    # keeps subgroups physically adjacent)
    used = devices[:new_data * model]
    return RecoveryPlan(
        surviving_hosts=topology.surviving_hosts(dead),
        devices=used,
        data_axis=new_data,
        model_axis=model,
        accum_factor=plan.accum_factor,
        elastic=plan,
    )


# --------------------------------------------------------------------- #
# failure / straggler injection (tests, CI smokes, benchmarks)
# --------------------------------------------------------------------- #
def parse_fail_spec(spec) -> tuple[int, list[int]]:
    """Parse ``--fail-at STEP[:HOSTS]`` → ``(step, failed_hosts)``.

    ``"12"`` → ``(12, [])`` (transient failure, RESTART path);
    ``"12:1,3"`` → ``(12, [1, 3])`` (lost hosts, ELASTIC_SHRINK path);
    ``-1`` / ``""`` / ``None`` → ``(-1, [])`` (no injection).  Accepts an
    int for backward compatibility with programmatic callers.
    """
    if spec is None:
        return -1, []
    if isinstance(spec, int):
        return spec, []
    spec = str(spec).strip()
    if not spec:
        return -1, []
    step_s, _, hosts_s = spec.partition(":")
    step = int(step_s)
    hosts = [int(h) for h in hosts_s.split(",") if h.strip()] \
        if hosts_s else []
    return step, hosts


def parse_straggle_specs(specs) -> dict[int, float]:
    """Parse repeated ``--straggle HOST:FACTOR`` → ``{host: factor}``.

    A factor of 2.0 simulates a host running 2x slower than nominal.
    """
    out: dict[int, float] = {}
    for s in specs or []:
        host_s, _, fac_s = str(s).partition(":")
        if not fac_s:
            raise ValueError(f"--straggle expects HOST:FACTOR, got {s!r}")
        fac = float(fac_s)
        if fac < 1.0:
            raise ValueError(f"straggle factor must be >= 1.0, got {s!r}")
        out[int(host_s)] = fac
    return out


@dataclasses.dataclass
class FailureInjector:
    """Raises one :class:`TrainingFailure` when the loop reaches
    ``fail_step`` (idempotent: replayed steps after recovery pass)."""

    fail_step: int = -1
    fail_hosts: list[int] = dataclasses.field(default_factory=list)
    fired: bool = False

    def maybe_fail(self, step: int) -> None:
        if step == self.fail_step and not self.fired:
            self.fired = True
            raise TrainingFailure(
                f"injected failure at step {step}"
                + (f" (lost hosts {self.fail_hosts})" if self.fail_hosts
                   else ""),
                failed_hosts=list(self.fail_hosts))


@dataclasses.dataclass(frozen=True)
class StragglerSim:
    """Synthetic per-host step times for straggler injection.

    Every simulated host's work runs in the one measured wall time (in
    the port, rank 0's, broadcast to every rank); the simulator inflates
    it per host by the configured factor — exactly the signal a real
    per-host heartbeat would carry — and the step time becomes the max
    over hosts (the straggler bounds the step).
    """

    factors: dict[int, float] = dataclasses.field(default_factory=dict)

    def host_time(self, host: int, base_seconds: float) -> float:
        return base_seconds * self.factors.get(host, 1.0)

    def step_time(self, base_seconds: float, hosts) -> float:
        return max((self.host_time(h, base_seconds) for h in hosts),
                   default=base_seconds)

    def observe(self, monitor: StragglerMonitor, base_seconds: float,
                hosts) -> float:
        """Feed one step's per-host times into ``monitor``; returns the
        simulated (straggler-bounded) step time."""
        for h in hosts:
            monitor.record_host_step(h, self.host_time(h, base_seconds))
        t = self.step_time(base_seconds, hosts)
        monitor.record_step(t)
        return t


# --------------------------------------------------------------------- #
# supervision
# --------------------------------------------------------------------- #
class ElasticSupervisor:
    """Failure supervision with degree-replanning shrink.

    Wraps a step loop (either train path): runs ``step_fn(step)``,
    catches :class:`TrainingFailure`, accumulates the dead-host set,
    decides RESTART / ELASTIC_SHRINK / ABORT against the real survivor
    count, and on shrink hands the driver a :class:`RecoveryPlan` for the
    surviving topology.  ``on_restore(action, plan)`` (plan is ``None``
    for RESTART) reloads the checkpoint — resharded onto the new mesh for
    a shrink — and returns the step to resume from; the deterministic
    pipeline replays ``[resume, failure)`` bit-identically.
    """

    def __init__(self, topology: HostTopology, policy: FailurePolicy, *,
                 data: int, model: int,
                 monitor: StragglerMonitor | None = None,
                 logger: Callable[[str], None] = print):
        assert topology.num_devices == data * model, \
            (topology, data, model)
        self.topology = topology
        self.policy = policy
        self.monitor = monitor
        self.logger = logger
        self.data = data
        self.model = model
        self.dead: set[int] = set()
        self.plan: RecoveryPlan | None = None   # latest shrink, if any

    # ----------------------------------------------------------------- #
    @property
    def alive_hosts(self) -> int:
        return self.topology.num_hosts - len(self.dead)

    def surviving_hosts(self) -> list[int]:
        return self.topology.surviving_hosts(self.dead)

    def current_axes(self) -> tuple[int, int]:
        """(data, model) of the current (possibly shrunk) mesh."""
        if self.plan is not None:
            return self.plan.data_axis, self.plan.model_axis
        return self.data, self.model

    def device_speeds(self) -> np.ndarray | None:
        """Per-device speed factors for the *current* device list, from
        the straggler monitor's per-host EMAs (None without a monitor).

        Device ``d`` of the current flat order belongs to the ``d // dph``-th
        *surviving* host; speeds follow that mapping, so after a shrink
        the weights track the renumbered grid automatically.
        """
        if self.monitor is None:
            return None
        dph = self.topology.devices_per_host
        d_axis, m_axis = self.current_axes()
        n_dev = d_axis * m_axis
        hosts = self.surviving_hosts()
        speeds = self.monitor.host_speeds(hosts)
        dev = np.repeat(speeds, dph)[:n_dev]
        return dev if dev.size == n_dev else None

    # ----------------------------------------------------------------- #
    def run(self, step_fn: Callable[[int], None], *, start_step: int,
            total_steps: int,
            on_restore: Callable[[FailureAction, RecoveryPlan | None],
                                 int]) -> int:
        step = start_step
        while step < total_steps:
            try:
                step_fn(step)
                step += 1
            except TrainingFailure as e:
                self.dead.update(e.failed_hosts)
                action = self.policy.decide(self.alive_hosts,
                                            e.failed_hosts)
                self.logger(
                    f"[recovery] step {step} failed ({e}); "
                    f"alive {self.alive_hosts}/{self.topology.num_hosts}; "
                    f"action={action.value}")
                if action == FailureAction.ABORT:
                    raise
                plan = None
                if action == FailureAction.ELASTIC_SHRINK:
                    try:
                        plan = replan_after_failure(
                            self.topology, self.dead,
                            data=self.data, model=self.model)
                    except ValueError as ve:
                        self.logger(f"[recovery] shrink infeasible: {ve}")
                        raise e from ve
                    self.plan = plan
                    self.logger(
                        f"[recovery] shrink -> mesh "
                        f"{plan.data_axis}x{plan.model_axis} on "
                        f"{plan.n_devices} surviving devices "
                        f"(accum {plan.accum_factor})")
                step = on_restore(action, plan)
        return step
