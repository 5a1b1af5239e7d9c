"""Exposed-communication schedule model (the port's counterpart of the
reference's ``hlo_analysis.schedule_model``, which list-schedules XLA's
partitioned HLO).

Here the program is a **trace**: one pass of a function on the ``meta``
device inside :class:`ScheduleTrace` (nothing is computed or
allocated), op by op, with

* each op's FLOPs and bytes as :class:`~repro_torch.launch.cost_analysis.
  CostMode` counts them (``torch.utils.flop_counter``'s formulas; every
  tensor argument's and result's bytes);
* each op's inputs by tensor identity: the storage each tensor views, so
  that a view or an in-place write carries its dependency (the op that
  last wrote a storage is the producer of every tensor over it);
* the collectives from the recording communicator
  (:class:`TracingComm`, a :class:`~repro_torch.core.comm.RecordingComm`):
  one collective per call the communicator counts, with the wire bytes
  it counts by kind (``wire_bytes_by_kind``: a hop its tensors once, an
  all-gather its piece x (g-1), a reduce-scatter and an all-to-all
  (g-1)/g of their operand, an all-reduce 2(g-1)/g).  A ``hop_start``
  issues its transfer and the received buffers are first read after its
  ``hop_wait``, so a hop overlaps exactly the ops traced between the
  two, as XLA's scheduler lets the reference's permutes overlap.

Views and allocations (``empty``, ``empty_like``, ``new_empty``, ...)
move no bytes and take no stream: they finish when their inputs do.

:func:`schedule_model` then runs the reference's two-resource list
schedule over the trace: compute ops in trace order on one stream, each
taking max(flops / flops_per_s, bytes / bytes_per_s), collectives on a
second stream, each taking its wire bytes / wire_per_s; an op starts
when its inputs are done and its stream is free.  An eager trace is
unrolled, so the reference's recursion into ``while`` bodies (a body's
schedule x its trip count, both streams serialized) has no counterpart:
a Python loop traces every trip.

The default rates are the reference's (a CPU-mesh harness), so ratios
between two programs compare with the reference's; ``hw=`` takes the
card's (``autotune.cost_model.HW``: ``peak_flops``, ``hbm_bw``,
``ici_bw``).  Either way the output is a model, not a measurement.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.comm import RecordingComm
from .cost_analysis import CostMode, _leaves

__all__ = ["ScheduleCost", "ScheduleTrace", "TracedOp", "TracingComm",
           "schedule_model"]

aten = torch.ops.aten

#: ops that allocate and write nothing
_ALLOC = frozenset({
    aten.empty.memory_format, aten.empty_like.default,
    aten.new_empty.default, aten.empty_strided.default,
    aten.new_empty_strided.default,
})


@dataclasses.dataclass
class ScheduleCost:
    """List-schedule estimate of one traced program's time.

    ``exposed_comm_s = makespan_s - compute_busy_s``: the part of the
    critical path where the compute stream sits idle waiting on
    collectives.  A blocking exchange exposes its full wire time; a
    pipelined exchange only the residue its per-hop compute cannot cover.
    """
    makespan_s: float
    compute_busy_s: float
    comm_busy_s: float
    exposed_comm_s: float
    collective_count: float


@dataclasses.dataclass(frozen=True)
class TracedOp:
    """One op of a trace: ``kind`` is ``"compute"``, ``"collective"``
    or ``"free"`` (a view or an allocation); ``deps`` are the indices of
    the ops that produced its inputs."""
    name: str
    kind: str
    flops: int = 0
    bytes: int = 0
    wire: int = 0
    deps: tuple = ()


def _written(func, args, kwargs) -> list:
    """The tensor arguments an in-place or ``out=`` op writes."""
    if not func._schema.is_mutable:
        return []
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        x = args[i] if i < len(args) else kwargs.get(a.name)
        for t in (x if isinstance(x, (list, tuple)) else (x,)):
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out


class ScheduleTrace(CostMode):
    """Records the ops run inside it (see the module docstring) into
    ``records``; ``comm`` is rank ``rank`` of a recording group of ``size``
    whose collectives enter the same trace."""

    def __init__(self, rank: int = 0, size: int = 1):
        super().__init__()
        self.records: list[TracedOp] = []
        self._writer = WeakIdKeyDictionary()    # storage -> op index
        self.comm = TracingComm(self, rank, size)

    def record(self, name: str, kind: str, ins, outs, *, flops: int = 0,
               nbytes: int = 0, wire: int = 0) -> None:
        """Append one op reading ``ins`` and writing ``outs``."""
        deps = {self._writer.get(t.untyped_storage()) for t in ins}
        deps.discard(None)
        i = len(self.records)
        self.records.append(TracedOp(name, kind, flops, nbytes, wire,
                                     tuple(sorted(deps))))
        for t in outs:
            self._writer[t.untyped_storage()] = i

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flops, nbytes = self.flops, self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        ins = [t for t in _leaves(args, kwargs)
               if isinstance(t, torch.Tensor)]
        outs = [t for t in (out if isinstance(out, (list, tuple))
                            else (out,)) if isinstance(t, torch.Tensor)]
        outs += _written(func, args, kwargs)
        if func.is_view or func in _ALLOC:
            self.record(str(func), "free", ins, outs)
        else:
            self.record(str(func), "compute", ins, outs,
                        flops=self.flops - flops, nbytes=self.bytes - nbytes)
        return out


class TracingComm(RecordingComm):
    """A :class:`RecordingComm` whose collectives enter ``trace``: each
    call the communicator counts (``count_kind``) becomes one collective
    op when it is issued, with the bytes counted for it; it reads the
    wire tensor and writes the received ones."""

    def __init__(self, trace: ScheduleTrace, rank: int, size: int):
        super().__init__(rank, size)
        self._trace = trace
        self._pending = []          # (kind, wire bytes) counted, not issued

    def count_kind(self, kind: str, xs, factor: float = 1.0,
                   result: float = 1.0) -> None:
        before = self.wire_bytes_by_kind[kind]
        super().count_kind(kind, xs, factor, result)
        self._pending.append((kind, self.wire_bytes_by_kind[kind] - before))

    def _issue(self, ins, outs) -> None:
        kind, wire = self._pending.pop(0)
        self._trace.record(kind, "collective", ins, outs, wire=wire)

    def _run(self, kind: str, out, wire, op=None) -> None:
        if self._pending:           # a broadcast counts no bytes
            self._issue([wire], [wire if out is None else out])

    def start(self, xs, shift: int = 1, tag: str = "forward"):
        transfer = super().start(xs, shift, tag)
        self._issue(xs, transfer.recv)
        return transfer


def schedule_model(trace, *, flops_per_s: float = 100e9,
                   bytes_per_s: float = 100e9, wire_per_s: float = 25e9,
                   hw: dict | None = None) -> ScheduleCost:
    """Dependency-aware two-resource schedule of ``trace`` (a
    :class:`ScheduleTrace` or a sequence of :class:`TracedOp`).

    Compute ops run in trace order on one stream (duration = max(flops,
    bytes) roofline), collectives on a communication stream (duration =
    wire bytes); an op starts when its inputs are done and its stream is
    free, so independent comm and compute overlap.  ``hw`` (e.g.
    ``autotune.cost_model.HW``) replaces the three rates by its
    ``peak_flops``, ``hbm_bw`` and ``ici_bw``.
    """
    if hw is not None:
        flops_per_s, bytes_per_s, wire_per_s = \
            hw["peak_flops"], hw["hbm_bw"], hw["ici_bw"]
    ops = getattr(trace, "records", trace)
    finish: list[float] = []
    t_cu = t_cm = busy_cu = busy_cm = n_coll = 0.0
    for op in ops:
        ready = max((finish[d] for d in op.deps), default=0.0)
        if op.kind == "collective":
            dur = op.wire / wire_per_s
            start = max(ready, t_cm)
            t_cm = start + dur
            busy_cm += dur
            n_coll += 1
        elif op.kind == "compute":
            dur = max(op.flops / flops_per_s, op.bytes / bytes_per_s)
            start = max(ready, t_cu)
            t_cu = start + dur
            busy_cu += dur
        else:
            start, dur = ready, 0.0
        finish.append(start + dur)
    makespan = max(max(finish, default=0.0), t_cu, t_cm)
    return ScheduleCost(makespan_s=makespan, compute_busy_s=busy_cu,
                        comm_busy_s=busy_cm,
                        exposed_comm_s=max(0.0, makespan - busy_cu),
                        collective_count=n_coll)
