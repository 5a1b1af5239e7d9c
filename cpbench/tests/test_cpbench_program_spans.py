"""The readers of the port's own spans and counters (``repro_torch.obs``)
on a hand-made recorder and trace, each giving nothing where there is
nothing to read, and the tiny CPU cell's traced run, which carries the
host-side ones and leaves out those that need the card."""

import json
import sys
import time
import types

import pytest

from cpbench.manifest import load_reader
from cpbench.port import import_port
from cpbench.trace import read_trace

import_port()
from repro_torch import obs  # noqa: E402

HOST = ("plan_span_ms_per_step", "h2d_ms_per_step", "gc_ms_per_step")
DEVICE = ("forward_ms_per_step", "backward_ms_per_step",
          "optimizer_ms_per_step", "doc_attn_ms_per_step", "step_gap_ms",
          "alloc_retries_per_step")


def _rec(name, step=None, host_ms=0.0, dev=None, **extra):
    r = {"name": name, "step": step, "host_ms": host_ms, "parent": None}
    if dev is not None:
        r.update(device_start_ms=dev[0], device_end_ms=dev[1],
                 device_ms=dev[1] - dev[0])
    r.update(extra)
    return r


def _summary():
    recs = [
        # a step before the window: left out
        _rec("step", 1, dev=(-50, -10)), _rec("step.forward", 1,
                                              dev=(-50, -40)),
        _rec("step", 2, dev=(0, 100)),
        _rec("step.forward", 2, dev=(0, 30)),
        _rec("step.backward", 2, dev=(30, 90)),
        _rec("step.optimizer", 2, dev=(90, 99)),
        _rec("step", 3, dev=(110, 220)),
        _rec("step.forward", 3, dev=(110, 125)),     # two micro-batches
        _rec("step.forward", 3, dev=(125, 140)),
        _rec("step.backward", 3, dev=(140, 200)),
        _rec("step.optimizer", 3, dev=(200, 219)),
        _rec("gc", None, 4.0, generation=0), _rec("gc", 2, 6.0,
                                                  generation=2),
        _rec("batch_to_device", None, 2.0), _rec("batch_to_device", None,
                                                 3.0),
        _rec("plan", None, 5.0), _rec("encode", None, 1.0),
        _rec("tables", None, 2.0),
        _rec("plan", None, 7.0), _rec("encode", None, 1.0),
        _rec("tables", None, 2.0),
    ]
    return {"records": recs, "spans": {},
            "counters": {"alloc_retries": {1: 5, 2: 1, 3: 0}}}


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(tmp_path):
    ev = [
        _event("user_annotation", "cpbench.window", 0, 100),
        _event("user_annotation", "cpbench.doc_attention", 4, 20),
        _event("user_annotation", "repro_torch.doc_attention.fwd", 5, 10),
        # the run-start table, launched from an operator inside the range
        _event("cpu_op", "aten::cumsum", 6, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 6.5, 0.2,
               correlation=1),
        _event("kernel", "cumsum", 20, 2, tid=7, correlation=1, device=0),
        # the kernel, launched from the port's range itself
        _event("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=2),
        _event("kernel", "fwd_mma_kernel", 22, 20, tid=7, correlation=2,
               device=0),
        # a backward kernel on the autograd engine's thread
        _event("user_annotation", "cpbench.doc_attention", 29, 7, tid=2),
        _event("user_annotation", "repro_torch.doc_attention.dq", 30, 5,
               tid=2),
        _event("cuda_runtime", "cudaLaunchKernel", 31, 1, tid=2,
               correlation=3),
        _event("kernel", "dq_mma_kernel", 45, 15, tid=7, correlation=3,
               device=0),
        # a GEMM elsewhere
        _event("cpu_op", "aten::mm", 50, 3),
        _event("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=4),
        _event("kernel", "sm90_gemm", 60, 10, tid=7, correlation=4,
               device=0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return read_trace(path, "cpbench.window", "cpbench.doc_attention")


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(obs, "summary", _summary)


def _run(trace=None, steps=(2, 3)):
    return types.SimpleNamespace(trace=trace, steps=[{"step": s}
                                                     for s in steps])


@pytest.mark.parametrize("name, value", [
    ("forward_ms_per_step", (30 + 30) / 2),
    ("backward_ms_per_step", (60 + 60) / 2),
    ("optimizer_ms_per_step", (9 + 19) / 2),
    ("step_gap_ms", 110 - 100),
    ("alloc_retries_per_step", (1 + 0) / 2),
    ("gc_ms_per_step", (4 + 6) / 2),
    ("h2d_ms_per_step", (2 + 3) / 2),
    ("plan_span_ms_per_step", (5 + 1 + 2 + 7 + 1 + 2) / 2),
])
def test_span_readers_by_hand(recorded, name, value):
    assert load_reader(name)(_run()) == pytest.approx(value)


def test_doc_attention_by_the_ports_launch_site(tmp_path):
    tr = _trace(tmp_path)
    # the harness's range holds all three kernels; the port's ranges are
    # the launch sites of the two doc kernels (20 + 15 µs), not of the
    # operator launched inside them
    assert tr.kind_s("attn") == pytest.approx(37e-6)
    run = _run(tr, steps=(2,))
    assert load_reader("doc_attn_ms_per_step")(run) == \
        pytest.approx(35e-3)


def test_gaps_need_consecutive_steps(recorded):
    assert load_reader("step_gap_ms")(_run(steps=(2,))) is None
    assert load_reader("step_gap_ms")(_run(steps=(1, 2, 3))) == \
        pytest.approx((0 - -10 + 110 - 100) / 2)


def test_none_where_nothing_is_recorded(monkeypatch, tmp_path):
    monkeypatch.setattr(obs, "summary", lambda: {"records": [], "spans": {},
                                                 "counters": {}})
    for name in HOST + DEVICE:
        assert load_reader(name)(_run()) is None, name
    # a trace with no range of the port's
    tr = read_trace(_write(tmp_path, [
        _event("user_annotation", "cpbench.window", 0, 100)]),
        "cpbench.window", "cpbench.doc_attention")
    assert load_reader("doc_attn_ms_per_step")(_run(tr)) is None


def test_none_without_the_recorder(monkeypatch):
    """A checkout whose port has no recorder: every reader gives
    nothing and none raises."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    for name in HOST + DEVICE:
        assert load_reader(name)(_run()) is None, name


def test_host_readers_read_zero_where_nothing_ran(monkeypatch):
    monkeypatch.setattr(obs, "summary", lambda: {
        "records": [_rec("step", 2)], "spans": {}, "counters": {}})
    assert load_reader("gc_ms_per_step")(_run()) == 0.0
    assert load_reader("h2d_ms_per_step")(_run()) is None


def _write(tmp_path, events):
    path = tmp_path / "w.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_the_tiny_cells_traced_run_carries_the_host_side_metrics():
    from test_cpbench_cell import tiny_cell

    from cpbench.run import run_cell

    obs.reset()
    try:
        r = run_cell(tiny_cell(), 2 ** 31 + 29, 0.5, True, device="cpu",
                     t_start=time.perf_counter())
    finally:
        obs.reset()
    assert r["correct"], r["checks"]
    assert set(HOST) <= set(r["metrics"])
    assert not set(DEVICE) & set(r["metrics"])
    assert r["metrics"]["plan_span_ms_per_step"]["value"] > 0
