"""Spans and counters of the port's training path, kept in memory on the
profiler's clock.

Tracing is on exactly while a torch profiler is recording
(``torch.profiler.profile`` or ``torch.autograd.profiler.profile``):
there is no switch of its own.  Off, :func:`span` checks one flag and
returns a shared null context, and :func:`count` returns at once.  On,
each span

* opens ``torch.profiler.record_function("repro_torch.<name>")``, a
  ``user_annotation`` range in the profiler's trace beside the kernels it
  launches;
* is kept as a record: its name, thread, parent (the innermost open span
  of its thread; on the autograd engine's thread, where none is open, the
  innermost open span of the thread running the step), step id (given to
  the ``step`` span, inherited by every span under it) and its start and
  end from :func:`time.time_ns`, which is the trace's clock
  (``ts`` x 1e3 + ``baseTimeNanoseconds``);
* with ``device=True`` also records a CUDA event on the current stream at
  entry and exit; a span that opens a step on the device also counts the
  caching allocator's synchronising retries in it (``alloc_retries``).

Every Python garbage collection while tracing is on is a ``gc`` span
(with its ``generation``), on whatever thread it ran.  :func:`summary`
returns the records, the totals by name and the counters; :func:`reset`
drops them.

The spans of the training path and the counter (PERF.md §3 names the
per-layer metric that reads each): ``step``, ``step.forward``,
``step.backward``, ``step.optimizer`` (``launch/steps.py``),
``doc_attention.fwd`` / ``.dq`` / ``.dkv`` (``kernels/doc_attention.py``,
around the CUDA launches), ``plan``, ``encode``, ``tables`` (the planner),
``batch_to_device`` and ``gc``; the counter ``alloc_retries``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["span", "count", "summary", "reset", "PREFIX"]

#: the prefix of every span's range in the profiler's trace
PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "thread", "parent", "step", "start_ns", "end_ns",
                 "events", "attrs")

    def __init__(self, name, parent, step):
        self.name = name
        self.thread = threading.get_ident()
        self.parent = parent
        self.step = step
        self.start_ns = self.end_ns = None
        self.events = None
        self.attrs = None


class _Recorder:
    """The records and counters of one process."""

    def __init__(self):
        self.records: list[_Record] = []
        self.counters: dict = collections.Counter()
        self.lock = threading.Lock()
        self.local = threading.local()
        self.step_stack = None      # the open span stack of the step's thread

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def parent(self, stack):
        if stack:
            return stack[-1]
        owner = self.step_stack
        if owner and torch._C._current_graph_task_id() != -1:
            return owner[-1]        # the autograd engine's thread
        return None


_REC = _Recorder()


class _Span:
    __slots__ = ("rec", "rf", "stack", "retries", "opens_step")

    def __init__(self, name, step, device):
        stack = _REC.stack()
        parent = _REC.parent(stack)
        self.rec = _Record(name, parent,
                           step if step is not None or parent is None
                           else parent.step)
        self.stack = stack
        self.opens_step = step is not None
        self.retries = None
        if device:
            self.rec.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            if self.opens_step:
                self.retries = _alloc_retries()

    def __enter__(self):
        rec = self.rec
        rec.start_ns = time.time_ns()
        self.rf = _profiler.record_function(PREFIX + rec.name)
        self.rf.__enter__()
        if rec.events is not None:
            rec.events[0].record()
        self.stack.append(rec)
        if self.opens_step:
            _REC.step_stack = self.stack
        _REC.records.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        if self.retries is not None:
            count("alloc_retries", _alloc_retries() - self.retries)
        self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        self.stack.pop()
        if self.opens_step:
            _REC.step_stack = None
        return False


def _alloc_retries() -> int:
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def span(name: str, *, step: int | None = None, device: bool = False):
    """A context over the work called ``name``: a null context while no
    profiler records, else a recorded span (see the module's docstring).
    ``step`` marks the span that opens a training step; ``device=True``
    (for work on a CUDA device only) times it with CUDA events too."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, step, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span's
    step, while a profiler records."""
    if _profiler._is_profiler_enabled:
        parent = _REC.parent(_REC.stack())
        step = None if parent is None else parent.step
        with _REC.lock:
            _REC.counters[name, step] += int(n)


def _on_gc(phase, info):
    """A ``gc`` span around each collection while a profiler records."""
    local = _REC.local
    if phase == "start":
        if _profiler._is_profiler_enabled:
            s = _Span("gc", None, False)
            s.rec.attrs = {"generation": info["generation"]}
            s.__enter__()
            local.gc = s
    else:
        s = getattr(local, "gc", None)
        if s is not None:
            local.gc = None
            s.__exit__(None, None, None)


gc.callbacks.append(_on_gc)


def _covered(start, end, intervals) -> int:
    """Length of the union of ``intervals`` inside [start, end)."""
    total, cur = 0, start
    for s, e in sorted(intervals):
        s, e = max(s, cur), min(e, end)
        if e > s:
            total += e - s
            cur = e
    return total


def summary() -> dict:
    """What the recorder holds, closed spans only:

    * ``records``: one dict a span, in the order they opened, with
      ``name``, ``thread``, ``parent`` (an index into ``records`` or
      None), ``step``, ``start_ns``, ``end_ns``, ``host_ms``, ``self_ms``
      (the duration less the part its children cover) and, for a span
      timed on the device, ``device_start_ms`` and ``device_end_ms`` (from
      the first such span's entry event) and ``device_ms``; a ``gc`` span
      also its ``generation``;
    * ``spans``: by name, ``calls``, ``host_ms``, ``self_ms`` and
      ``device_ms`` (None where no span of the name was timed on the
      device);
    * ``counters``: by name, ``{step: n}``.
    """
    recs = [r for r in list(_REC.records) if r.end_ns is not None]
    index = {id(r): i for i, r in enumerate(recs)}
    kids = collections.defaultdict(list)
    for r in recs:
        if r.parent is not None and id(r.parent) in index:
            kids[id(r.parent)].append((r.start_ns, r.end_ns))
    timed = [r for r in recs if r.events is not None]
    origin = None
    if timed:
        torch.cuda.synchronize()
        origin = timed[0].events[0]
    out, spans = [], {}
    for r in recs:
        host = (r.end_ns - r.start_ns) * 1e-6
        d = {"name": r.name, "thread": r.thread,
             "parent": index.get(id(r.parent)), "step": r.step,
             "start_ns": r.start_ns, "end_ns": r.end_ns, "host_ms": host,
             "self_ms": host - _covered(r.start_ns, r.end_ns,
                                        kids[id(r)]) * 1e-6}
        if r.events is not None:
            d["device_start_ms"] = origin.elapsed_time(r.events[0])
            d["device_end_ms"] = origin.elapsed_time(r.events[1])
            d["device_ms"] = d["device_end_ms"] - d["device_start_ms"]
        if r.attrs:
            d.update(r.attrs)
        out.append(d)
        agg = spans.setdefault(r.name, {"calls": 0, "host_ms": 0.0,
                                        "self_ms": 0.0, "device_ms": None})
        agg["calls"] += 1
        agg["host_ms"] += d["host_ms"]
        agg["self_ms"] += d["self_ms"]
        if "device_ms" in d:
            agg["device_ms"] = (agg["device_ms"] or 0.0) + d["device_ms"]
    counters: dict = {}
    with _REC.lock:
        for (name, step), n in _REC.counters.items():
            counters.setdefault(name, {})[step] = n
    return {"records": out, "spans": spans, "counters": counters}


def reset() -> None:
    """Drop every record and counter."""
    with _REC.lock:
        _REC.records.clear()
        _REC.counters.clear()
