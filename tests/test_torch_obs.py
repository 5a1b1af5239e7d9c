"""The port's recorder (``repro_torch.obs``): off without a profiler, on
the profiler's clock and in its trace while one records, and the spans
of one training step, the planner, the batch upload and the garbage
collector.

The ``gpu`` tests need a CUDA device and skip without one:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_obs.py``.
"""

import gc
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.configs as cfgs
from repro_torch import obs
from repro_torch.data.pipeline import PipelineConfig, make_batch
from repro_torch.launch.steps import batch_to_device, build_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw_init

STEP_SPANS = ("step", "step.forward", "step.backward", "step.optimizer")


@pytest.fixture(autouse=True)
def fresh():
    obs.reset()
    yield
    obs.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(s):
    out = {}
    for i, r in enumerate(s["records"]):
        out.setdefault(r["name"], []).append((i, r))
    return out


def test_off_without_a_profiler():
    null = obs.span("step", step=1, device=False)
    assert obs.span("anything") is null
    with null:
        obs.count("alloc_retries", 3)
        gc.collect()
    s = obs.summary()
    assert s == {"records": [], "spans": {}, "counters": {}}


def test_spans_nest_with_parent_step_and_self_time():
    with _cpu_profile():
        with obs.span("outer", step=5):
            with obs.span("inner"):
                time.sleep(0.02)
                obs.count("things", 2)
            time.sleep(0.01)
            with obs.span("second"):
                obs.count("things")
        with obs.span("alone"):
            pass
    s = obs.summary()
    by = _by_name(s)
    (io, outer), = by["outer"]
    (_, inner), = by["inner"]
    (_, second), = by["second"]
    (_, alone), = by["alone"]
    assert outer["parent"] is None and outer["step"] == 5
    assert inner["parent"] == io and inner["step"] == 5
    assert second["parent"] == io and second["step"] == 5
    assert alone["parent"] is None and alone["step"] is None
    assert inner["host_ms"] >= 20 and outer["self_ms"] >= 10
    # self time: the duration less its children's (here one after the
    # other on one thread; a collection may add a ``gc`` child)
    for i, r in enumerate(s["records"]):
        kids = [k["host_ms"] for k in s["records"] if k["parent"] == i]
        assert r["self_ms"] == pytest.approx(r["host_ms"] - sum(kids))
    assert s["counters"] == {"things": {5: 3}}
    assert s["spans"]["outer"]["calls"] == 1
    assert s["spans"]["outer"]["device_ms"] is None
    assert "device_ms" not in outer


def test_a_thread_inside_the_steps_backward_is_adopted():
    """A span opened on a thread with no span open, while it runs a
    backward (as the autograd engine's device threads do), is a child of
    the step's open phase; a thread outside any backward is not."""
    seen = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            with obs.span("inside"):
                pass
            return g * 2

    def backward_thread():
        x = torch.ones(3, requires_grad=True)
        torch.autograd.grad(Probe.apply(x).sum(), x)

    def plain_thread():
        with obs.span("elsewhere"):
            pass

    with _cpu_profile():
        with obs.span("step", step=9):
            with obs.span("step.backward"):
                for fn in (backward_thread, plain_thread):
                    t = threading.Thread(target=fn)
                    t.start()
                    t.join(timeout=60)
                    seen[fn.__name__] = t.is_alive()
    assert seen == {"backward_thread": False, "plain_thread": False}
    by = _by_name(obs.summary())
    (bi, _), = by["step.backward"]
    (_, inside), = by["inside"]
    (_, elsewhere), = by["elsewhere"]
    assert inside["parent"] == bi and inside["step"] == 9
    assert inside["thread"] != threading.get_ident()
    assert elsewhere["parent"] is None and elsewhere["step"] is None


def test_threads_keep_their_own_nesting_and_every_count():
    """More threads than cores open nested spans and count at once, with
    a short switch interval: every record keeps its own thread's parent
    and no count is lost."""
    threads, rounds = 16, 200
    switch = sys.getswitchinterval()

    def work(i):
        for _ in range(rounds):
            with obs.span("outer", step=i):
                with obs.span("inner"):
                    obs.count("n")

    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            pool = [threading.Thread(target=work, args=(i,))
                    for i in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            alive = [t.is_alive() for t in pool]
    finally:
        sys.setswitchinterval(switch)
    assert not any(alive)
    s = obs.summary()
    assert sum(s["counters"]["n"].values()) == threads * rounds
    assert s["counters"]["n"] == {i: rounds for i in range(threads)}
    recs = s["records"]
    inner = [r for r in recs if r["name"] == "inner"]
    assert len(inner) == threads * rounds
    for r in inner:
        parent = recs[r["parent"]]
        assert parent["name"] == "outer"
        assert parent["thread"] == r["thread"]
        assert parent["step"] == r["step"]


def test_spans_are_user_annotations_on_the_trace_clock(tmp_path):
    with _cpu_profile() as prof:
        with obs.span("step", step=0):
            with obs.span("step.forward"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with obs.span("plan"):
            time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    ranges = {e["name"]: e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"}
    recs = obs.summary()["records"]
    assert {r["name"] for r in recs} <= {"step", "step.forward", "plan",
                                         "gc"}
    for r in recs:
        if r["name"] == "gc":
            continue
        ev = ranges[obs.PREFIX + r["name"]]
        assert abs(r["start_ns"] - (ev["ts"] * 1e3 + base)) < 1e6
        assert abs(r["end_ns"] - (ev["ts"] + ev["dur"]) * 1e3 - base) < 1e6


def _tiny_step(device):
    cfg = cfgs.reduce_for_smoke(cfgs.get_config("starcoder2_3b"))
    run = cfgs.RunConfig(attention_impl="flash", kernel_grid="flat")
    pipe = PipelineConfig(context_len=256, batch_per_host=2,
                          vocab_size=cfg.vocab_size, emit_tables=True,
                          table_grid="flat", align=128)
    params = init_params(cfg, device=device)
    step_fn = build_train_step(cfg, run, q_chunk=64, block_q=64,
                               block_k=64, device=device)
    return step_fn, params, adamw_init(params), pipe


def _check_step(s, step):
    by = _by_name(s)
    (si, rec), = by["step"]
    assert rec["step"] == step and rec["parent"] is None
    for name in STEP_SPANS[1:]:
        (_, r), = by[name]
        assert r["step"] == step and r["parent"] == si, name
        assert r["start_ns"] >= rec["start_ns"]
        assert r["end_ns"] <= rec["end_ns"]
    return by


def test_one_cpu_train_step_records_its_phases():
    step_fn, params, opt, pipe = _tiny_step("cpu")
    batch = make_batch(pipe, 0)
    dev = torch.device("cpu")
    with _cpu_profile():
        m = step_fn(params, opt, batch_to_device(batch, dev), 7)
        float(m["loss"])
    s = obs.summary()
    by = _check_step(s, 7)
    # the kernels' CPU twins launch nothing, so no doc-attention span
    assert not [n for n in by if n.startswith("doc_attention.")]
    assert "alloc_retries" not in s["counters"]
    assert s["spans"]["step"]["device_ms"] is None


def test_the_planner_records_its_three_parts():
    _, _, _, pipe = _tiny_step("cpu")
    with _cpu_profile():
        make_batch(pipe, 0)
    spans = obs.summary()["spans"]
    assert {n: spans[n]["calls"] for n in ("plan", "encode", "tables")} \
        == {"plan": 1, "encode": 1, "tables": 1}


def test_gc_collect_records_a_gc_span():
    with _cpu_profile():
        with obs.span("outer", step=2):
            gc.collect()
    recs = [r for r in obs.summary()["records"] if r["name"] == "gc"]
    full = [r for r in recs if r["generation"] == 2]
    assert full and full[-1]["thread"] == threading.get_ident()
    assert full[-1]["step"] == 2 and full[-1]["host_ms"] > 0


def test_batch_to_device_records_one_span():
    batch = {"tokens": np.zeros((2, 8), np.int32),
             "labels": np.zeros((2, 8), np.int32), "stats": {}}
    with _cpu_profile():
        out = batch_to_device(batch, "cpu")
    assert set(out) == {"tokens", "labels"}
    assert obs.summary()["spans"]["batch_to_device"]["calls"] == 1


def test_the_wgmma_forward_is_counted_inside_its_span(monkeypatch):
    """``flash_fwd`` counts a launch of the wgmma forward in
    ``.wgmma_launches`` and, under a profiler, in the
    ``doc_attention.fwd_wgmma`` counter of its step, inside its
    ``doc_attention.fwd`` span; a shape that goes to the mma.sync forward
    counts in neither.  The launch itself is stubbed (no card here)."""
    from repro_torch.kernels import doc_attention as da
    chosen = []
    monkeypatch.setattr(da, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(da, "_launch",
                        lambda kind, *a, **kw: chosen.append(kind))
    q = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 128, 64), dtype=torch.bfloat16)
    meta = [torch.zeros((1, 128), dtype=torch.int32)] * 4
    tables = (torch.zeros((1, 2, 2), dtype=torch.int32),
              torch.zeros((1, 2), dtype=torch.int32))
    before = da.flash_fwd.launches, da.flash_fwd.wgmma_launches
    with _cpu_profile():
        with obs.span("step", step=3):
            for bq in (64, 32):                 # wgmma, then mma.sync
                da.flash_fwd(q, k, k, *meta, tables, scale=0.125,
                             block_q=bq, block_k=64)
    assert chosen == ["fwd_wgmma", "fwd"]
    assert (da.flash_fwd.launches - before[0],
            da.flash_fwd.wgmma_launches - before[1]) == (2, 1)
    s = obs.summary()
    assert s["counters"]["doc_attention.fwd_wgmma"] == {3: 1}
    assert s["spans"]["doc_attention.fwd"]["calls"] == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_card_step_times_its_phases_on_the_device(card):
    step_fn, params, opt, pipe = _tiny_step(card)
    batches = [batch_to_device(make_batch(pipe, i), card) for i in (0, 1)]
    float(step_fn(params, opt, batches[0], 0)["loss"])     # builds, warms
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        float(step_fn(params, opt, batches[1], 1)["loss"])
    s = obs.summary()
    by = _check_step(s, 1)
    for name in STEP_SPANS:
        (_, r), = by[name]
        assert r["device_ms"] > 0, name
        assert r["device_end_ms"] >= r["device_start_ms"]
    retries = s["counters"]["alloc_retries"]
    assert set(retries) == {1} and retries[1] >= 0
    # the doc kernels run under their spans, the backward's on the
    # autograd engine's thread under the step's backward
    (bi, _), = by["step.backward"]
    (fi, _), = by["step.forward"]
    for name in ("doc_attention.dq", "doc_attention.dkv"):
        assert by[name] and all(r["parent"] == bi and r["step"] == 1
                                for _, r in by[name]), name
    assert {r["parent"] for _, r in by["doc_attention.fwd"]} <= {fi, bi}


@pytest.mark.gpu
def test_a_card_forward_counts_the_wgmma_kernel(card):
    """On the card the ``doc_attention.fwd_wgmma`` counter counts the
    forwards that ran ``fwd_wgmma_kernel``, and no other."""
    from repro_torch.kernels import doc_attention as da
    T = 256
    doc = np.zeros((1, T), np.int32)
    pos = np.arange(T, dtype=np.int32)[None]
    meta = [torch.from_numpy(a).to(card) for a in (doc, pos, doc, pos)]
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    q = torch.randn((1, 4, T, 64), generator=gen, device=card).bfloat16()
    k, v = (torch.randn((1, 2, T, 64), generator=gen, device=card)
            .bfloat16() for _ in range(2))
    before = da.flash_fwd.wgmma_launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with obs.span("step", step=5):
            for bq in (64, 32):                 # wgmma, then mma.sync
                tabs = da.build_block_tables(doc, pos, doc, pos,
                                             block_q=bq, block_k=64)
                da.flash_fwd(q, k, v, *meta, tabs.flat_as_torch(card)[:3],
                             scale=0.125, block_q=bq, block_k=64,
                             grid="flat")
        torch.cuda.synchronize()
    s = obs.summary()
    assert da.flash_fwd.wgmma_launches == before + 1
    assert s["counters"]["doc_attention.fwd_wgmma"] == {5: 1}
    assert s["spans"]["doc_attention.fwd"]["calls"] == 2
