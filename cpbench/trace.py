"""Read a profiler trace (``torch.profiler``'s Chrome trace) into what the
per-layer readers need: every device operation in the traced window with
the host call site it was launched from, the union of the device's busy
intervals, and the longest idle gaps.

A device operation is attributed by where it was launched, never by its
name: the launch (a CUDA runtime or driver call) carries the operation's
correlation id, and the host ranges open on the launching thread at that
moment say what launched it.  An operation launched inside the
benchmark's doc-attention range (``port.DOC_ATTN_SPAN``) is doc
attention; one launched from a matrix-product operator is a GEMM; an
NCCL kernel is communication; every other kernel, copy and fill is the
rest.
"""

from __future__ import annotations

import collections
import dataclasses
import json

__all__ = ["DeviceOp", "Trace", "read_trace", "union_length", "GEMM_OPS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
#: the operators whose kernels are matrix products
GEMM_OPS = frozenset({
    "aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
    "aten::addbmm", "aten::_scaled_mm", "aten::_addmm_activation",
    "aten::addmv", "aten::mv", "aten::dot"})


@dataclasses.dataclass
class DeviceOp:
    start: float          # µs, the trace's clock
    end: float
    name: str
    device: int
    kind: str             # "attn", "gemm", "nccl" or "other"
    site: str             # the innermost host range at its launch


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]       # µs
    ops: list[DeviceOp]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def devices(self) -> list[int]:
        return sorted({op.device for op in self.ops})

    def busy_s(self, device: int | None = None) -> float:
        """Seconds of the window in which some operation ran on
        ``device`` (None: averaged over the devices)."""
        devs = self.devices() if device is None else [device]
        if not devs:
            return 0.0
        return sum(union_length([(o.start, o.end) for o in self.ops
                                 if o.device == d], self.window)
                   for d in devs) * 1e-6 / len(devs)

    def kind_s(self, kind: str, device: int | None = None) -> float:
        """Summed seconds of the operations of ``kind``."""
        return sum(min(o.end, self.window[1]) - max(o.start, self.window[0])
                   for o in self.ops if o.kind == kind
                   and (device is None or o.device == device)
                   and o.end > self.window[0]
                   and o.start < self.window[1]) * 1e-6

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = collections.Counter()
        for o in self.ops:
            by[o.name[:120]] += (o.end - o.start) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest gaps in which no operation ran (on any
        device), each named by the host range that launched the
        operation ending it; a gap at the window's end is named
        ``"window end"``."""
        ops = sorted(self.ops, key=lambda o: o.start)
        gaps, t = [], self.window[0]
        for o in ops:
            if o.start > t:
                gaps.append((o.start - t, o.site))
            t = max(t, o.end)
        if self.window[1] > t:
            gaps.append((self.window[1] - t, "window end"))
        gaps.sort(key=lambda g: -g[0])
        return [[site, dt * 1e-6] for dt, site in gaps[:n]]


def union_length(intervals, window) -> float:
    """Length of the union of ``intervals`` inside ``window``."""
    lo, hi = window
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _sites(host: list, launches: list, attn_span: str) -> dict:
    """{correlation: (innermost host range, inside attn_span)} for the
    launches of one thread; host ranges nest on a thread."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, i = {}, [], 0
    for ts, corr in sorted(launches):
        while i < len(host) and host[i][0] <= ts:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[corr] = (stack[-1][2] if stack else "",
                     any(h[2] == attn_span for h in stack))
    return out


def _kind(name: str, site: str, in_attn: bool) -> str:
    if in_attn:
        return "attn"
    if name.lower().startswith("nccl") or "nccl" in site.lower():
        return "nccl"
    if site in GEMM_OPS:
        return "gemm"
    return "other"


def read_trace(path, window_span: str, attn_span: str) -> Trace:
    """The trace at ``path``, over the host range ``window_span``."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    host = collections.defaultdict(list)
    launches = collections.defaultdict(list)
    device, spans = [], collections.defaultdict(list)
    for ev in events:
        cat = ev.get("cat")
        if ev.get("ph") != "X" or cat is None:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in HOST_CATS:
            host[ev["tid"]].append((ts, ts + dur, ev["name"]))
            if cat == "user_annotation":
                spans[ev["name"]].append((ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[ev["tid"]].append((ts, corr))
        elif cat in DEVICE_CATS:
            device.append(ev)
    if window_span not in spans:
        raise ValueError(f"the trace has no {window_span!r} range")
    sites = {}
    for tid, ls in launches.items():
        sites.update(_sites(host.get(tid, []), ls, attn_span))
    lo, hi = spans[window_span][0]
    ops = []
    for ev in device:
        ts = float(ev["ts"])
        if ts >= hi or ts + float(ev.get("dur", 0.0)) <= lo:
            continue
        args = ev.get("args", {})
        site, in_attn = sites.get(args.get("correlation"), ("", False))
        ops.append(DeviceOp(ts, ts + float(ev.get("dur", 0.0)), ev["name"],
                            int(args.get("device", 0)),
                            _kind(ev["name"], site, in_attn), site))
    return Trace(window=(lo, hi), ops=ops)
