"""The FLOP and byte arithmetic of ``mfu`` and ``attn_roofline_pct`` on
hand-worked cases, and the trace reader on a hand-made trace."""

import json
import types

import numpy as np
import pytest

from cpbench import flops
from cpbench.manifest import load_reader
from cpbench.trace import read_trace, union_length

SPEC = types.SimpleNamespace(layers=2, d_model=8, heads=4, kv_heads=2,
                             head_dim=2, d_ff=16, vocab=10)
PEAKS = {"bf16_flops_per_s": 1e3, "hbm_bytes_per_s": 1e2}


def test_nonembedding_params_by_hand():
    # a layer: wq 8x8, wk and wv 8x4 each, wo 8x8, wi 8x16, wo 16x8, two
    # norms of 8 = 64 + 64 + 64 + 256 + 16 = 464; two layers 928; the
    # final norm 8 and the head 8 x 10
    assert flops.nonembedding_params(SPEC) == 928 + 8 + 80


def test_attention_flops_count_the_documents_pairs():
    # documents of 1 and 2 tokens: 1 + 3 causal pairs; 4 Hq d_head a
    # pair = 32; three passes; two layers
    assert flops.attention_flops(SPEC, [1, 2]) == 3 * 32 * 4 * 2
    # the need depends on the lengths only, not on where they sit
    assert flops.attention_flops(SPEC, [2, 1]) == \
        flops.attention_flops(SPEC, [1, 2])
    assert flops.attention_flops(SPEC, [3]) > \
        flops.attention_flops(SPEC, [1, 2])


def test_attention_bytes_by_hand():
    # per token: q, o, dO, dQ 4 x (4 x 2) and k, v, dK, dV 4 x (2 x 2)
    # bf16 values = 48 x 2 bytes, plus the lse's 4 x 4; two layers
    assert flops.attention_bytes(SPEC, 5) == (48 * 2 + 16) * 5 * 2


def test_the_card_peaks_are_published_values():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops_per_s"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("some other card")


def _event(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(tmp_path):
    ev = [
        _event("user_annotation", "cpbench.window", 0, 100),
        # a GEMM launched from aten::mm
        _event("cpu_op", "aten::mm", 1, 3),
        _event("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _event("kernel", "sm90_gemm", 10, 20, tid=7, correlation=1,
               device=0),
        # a kernel launched inside the doc-attention range, on the
        # backward's thread
        _event("user_annotation", "cpbench.doc_attention", 5, 10, tid=2),
        _event("cpu_op", "aten::empty", 6, 1, tid=2),
        _event("cuda_runtime", "cudaLaunchKernel", 8, 1, tid=2,
               correlation=2),
        _event("kernel", "anything", 20, 20, tid=8, correlation=2,
               device=0),
        # an elementwise kernel overlapping the GEMM on another stream
        _event("cpu_op", "aten::add", 50, 3),
        _event("cuda_runtime", "cudaLaunchKernel", 51, 1, correlation=3),
        _event("kernel", "elementwise", 60, 10, tid=7, correlation=3,
               device=0),
        _event("kernel", "ncclDevKernel_AllGather", 65, 10, tid=9,
               correlation=4, device=0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return read_trace(path, "cpbench.window", "cpbench.doc_attention")


def test_trace_attributes_by_launch_site(tmp_path):
    tr = _trace(tmp_path)
    kinds = {o.name: o.kind for o in tr.ops}
    assert kinds == {"sm90_gemm": "gemm", "anything": "attn",
                     "elementwise": "other",
                     "ncclDevKernel_AllGather": "nccl"}
    assert tr.kind_s("attn") == pytest.approx(20e-6)


def test_idle_is_the_union_not_the_sum(tmp_path):
    tr = _trace(tmp_path)
    # busy [10, 40) and [60, 75): 45 of 100 µs
    assert tr.busy_s() == pytest.approx(45e-6)
    assert union_length([(0, 5), (3, 8), (10, 12)], (0, 11)) == 9
    run = types.SimpleNamespace(trace=tr, steps=[{}])
    assert load_reader("device_idle_pct")(run) == pytest.approx(55.0)
    gaps = tr.idle_gaps(3)
    assert gaps == [["window end", pytest.approx(25e-6)],
                    ["aten::add", pytest.approx(20e-6)],
                    ["aten::mm", pytest.approx(10e-6)]]


def _run(tmp_path, steps):
    cell = types.SimpleNamespace(spec=SPEC, chips=1)
    return types.SimpleNamespace(trace=_trace(tmp_path), steps=steps,
                                 peaks=PEAKS, cell=cell)


def test_roofline_share_by_hand(tmp_path):
    steps = [{"doc_lens": [[1, 2]], "wait_s": 0.0}]
    run = _run(tmp_path, steps)
    need = max(flops.attention_flops(SPEC, [1, 2]) / 1e3,
               flops.attention_bytes(SPEC, 3) / 1e2)
    assert load_reader("attn_roofline_pct")(run) == \
        pytest.approx(100 * need / 20e-6)


def test_step_mfu_by_hand(tmp_path):
    steps = [{"doc_lens": [[1, 2]], "wait_s": 0.0}] * 2
    run = _run(tmp_path, steps)
    model = 2 * (6 * flops.nonembedding_params(SPEC) * 3
                 + flops.attention_flops(SPEC, [1, 2]))
    assert load_reader("step_mfu")(run) == \
        pytest.approx(100 * model / (100e-6 * 1e3))


def test_readers_return_nothing_without_a_trace():
    run = types.SimpleNamespace(trace=None, steps=[], peaks=PEAKS,
                                cell=None)
    for name in ("attn_roofline_pct", "device_idle_pct", "step_mfu",
                 "elementwise_ms_per_step", "batch_wait_ms",
                 "plan_ms_per_step"):
        assert load_reader(name)(run) is None


def test_batch_wait_is_the_mean_wait():
    run = types.SimpleNamespace(steps=[{"wait_s": 0.001},
                                       {"wait_s": 0.003}])
    assert load_reader("batch_wait_ms")(run) == pytest.approx(2.0)


def test_plan_ms_is_the_mean_planning_time():
    run = types.SimpleNamespace(steps=[{"plan_s": 0.002},
                                       {"plan_s": 0.006}])
    assert load_reader("plan_ms_per_step")(run) == pytest.approx(4.0)


def test_attention_work_of_a_row():
    from cpbench.traffic import attention_work
    assert attention_work(np.array([1, 2, 3])) == 1 + 3 + 6
