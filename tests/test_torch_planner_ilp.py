"""The planner leftovers of the port against the reference, bit for bit:
the exact branch-and-bound planner (``bnb``/``ilp``), the planning
thread pool (``plan_many``), the plan cache's quantized hits
(``granularity``), the ``PipelineConfig`` planner knobs through
``make_batch``, and the Eq. 4 / Eq. 5 accounting of ``core/workload.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.core.workload as jwork
import repro.data.pipeline as jpipe
import repro.planner as jpl
from repro.planner.ilp import bnb_plan as jbnb
import repro_torch.core.workload as twork
import repro_torch.data.pipeline as tpipe
from repro_torch import planner as tpl
from repro_torch.planner.ilp import bnb_plan as tbnb

torch.set_num_threads(1)


def _mix(seed: int, context: int, n_docs: int) -> np.ndarray:
    """A random length mix of ``n_docs`` documents summing to
    ``context`` (the reference tests' ``_doc_mix``)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, context), n_docs - 1,
                              replace=False))
    return np.diff(np.concatenate([[0], cuts, [context]])).astype(np.int64)


def _same_plan(a, b, what=""):
    for f in ("doc_id", "start", "length", "worker"):
        x, y = getattr(a.arrays, f), getattr(b.arrays, f)
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    np.testing.assert_array_equal(a.doc_lens, b.doc_lens)
    assert (a.num_workers, a.comm_style) == (b.num_workers, b.comm_style)
    assert a.imbalance_ratio() == b.imbalance_ratio()


# (seed, context, documents, N, lambda_comm, max_nodes): N 2-4, at most 10
# documents; the last two cut the search at max_nodes (the heuristic's
# plan or the best leaf so far, not proven optimal)
BNB_CASES = [(0, 2048, 7, 4, 0.5, 200_000), (1, 2048, 7, 4, 0.5, 200_000),
             (2, 1024, 5, 2, 0.5, 2_000_000), (3, 960, 6, 3, 0.25, 200_000),
             (4, 1536, 8, 3, 1.0, 200_000), (5, 4096, 10, 4, 0.5, 20_000),
             (6, 2048, 9, 4, 0.5, 50), (7, 512, 4, 2, 0.5, 3)]


@pytest.mark.parametrize("case", BNB_CASES, ids=lambda c: f"seed{c[0]}")
def test_bnb_matches_reference(case):
    """Plan arrays, objective, nodes explored and the optimality proof
    equal the reference's: the search visits the same nodes in the same
    order (worker-symmetry breaking, pruning, the node budget)."""
    seed, context, n_docs, N, lam, max_nodes = case
    lens = _mix(seed, context, n_docs)
    want = jbnb(lens, N, lambda_comm=lam, max_nodes=max_nodes)
    got = tbnb(lens, N, lambda_comm=lam, max_nodes=max_nodes)
    _same_plan(want.plan, got.plan, str(case))
    assert got.objective == want.objective
    assert got.nodes_explored == want.nodes_explored
    assert got.proven_optimal == want.proven_optimal
    if max_nodes < 100:
        assert not got.proven_optimal


def test_bnb_registered_as_the_reference():
    """``ilp`` is ``bnb``, with the reference's metadata, and the
    registered adapter plans as ``bnb_plan`` does."""
    assert tpl.get_planner("ilp") is tpl.get_planner("bnb")
    for name in ("bnb", "ilp"):
        assert dataclasses.asdict(tpl.planner_info(name)) == \
            dataclasses.asdict(jpl.planner_info(name))
    lens = _mix(11, 1024, 6)
    _same_plan(tpl.get_planner("ilp")(lens, 4, max_nodes=10_000),
               jpl.get_planner("ilp")(lens, 4, max_nodes=10_000))
    with pytest.raises(ValueError, match="does not split"):
        tbnb([5, 6], 4)


def test_plan_many_keeps_order_at_any_width():
    """``plan_many`` returns the plans in input order; widths 1 and 4
    give the reference pool's plans, on threads named after the port."""
    lens_list = [_mix(20 + i, 2048, 3 + i % 5) for i in range(9)]
    names = set()

    def plan(lens):
        names.add(threading.current_thread().name)
        return tpl.get_planner("flashcp")(lens, 4)

    one = tpl.plan_many(plan, lens_list, workers=1)
    four = tpl.plan_many(plan, lens_list, workers=4)
    want = jpl.plan_many(lambda l: jpl.get_planner("flashcp")(l, 4),
                         lens_list, workers=4)
    for lens, a, b, c in zip(lens_list, one, four, want):
        np.testing.assert_array_equal(a.doc_lens, lens)
        _same_plan(a, b)
        _same_plan(a, c)
    assert any(n.startswith("repro_torch-planner") for n in names)
    assert tpl.get_pool(4) is tpl.get_pool(4)
    assert tpl.default_workers(1) == 1 == jpl.parallel.default_workers(1)


@pytest.mark.parametrize("strategy", ["flashcp", "per_doc", "llama3"])
def test_plan_cache_quantized_hits_match_reference(strategy):
    """A granularity-64 cache on a stream of exact hits, quantized hits
    (lengths moved inside their buckets, reordered too), misses across a
    bucket and LRU evictions: the same plans (the adapted layouts) and
    the same statistics as the reference's."""
    a = np.asarray([1000, 500, 300, 248])          # 2048
    b = np.asarray([990, 505, 310, 243])           # a's buckets
    c = np.asarray([1100, 400, 300, 248])          # other buckets
    d = _mix(30, 2048, 6)
    stream = [a, b, b[::-1].copy(), a, c, d, b, a, c]
    for entries in (256, 2):
        jc = jpl.PlanCache(strategy, 4, granularity=64, max_entries=entries)
        tc = tpl.PlanCache(strategy, 4, granularity=64, max_entries=entries)
        for lens in stream:
            _same_plan(jc.plan(lens), tc.plan(lens), f"{strategy} {lens}")
        assert dataclasses.asdict(jc.stats) == dataclasses.asdict(tc.stats)
        assert jc.stats.hit_rate == tc.stats.hit_rate
        assert len(jc) == len(tc)
        if strategy == "flashcp" and entries == 256:
            assert tc.stats.quantized_hits >= 2


# a quantized hit adapts the plan of whichever mix reached the cache
# first, so with a quantized cache the rows of one batch are planned
# serially (on the pool, the threads' order would pick the plans, in the
# reference too); an exact cache returns the planner's own plans, so
# threads change no plan, but whether two equal mixes of one batch hit
# or both miss (the hit rate) is a race on both sides
PIPE_KNOBS = [
    dict(buf_len=512, cache_plans=False, cache_granularity=64,
         planner_workers=2),
    dict(cache_granularity=64, cache_entries=4, planner_workers=1),
    dict(cache_entries=2, planner_workers=2),
]


@pytest.mark.parametrize("knobs", PIPE_KNOBS,
                         ids=["fixed_buf", "quantized", "threads"])
def test_make_batch_knobs_match_reference(knobs):
    """``make_batch`` with the planner knobs set: every array and every
    statistic bit for bit the reference's, over steps that repeat (cache
    hits) and two data ranks."""
    kw = dict(dataset="pile", context_len=2048, batch_per_host=3,
              cp_size=4, strategy="flashcp", vocab_size=512, seed=3,
              align=16, **knobs)
    jcfg, tcfg = jpipe.PipelineConfig(**kw), tpipe.PipelineConfig(**kw)
    for step, rank in ((0, 0), (1, 1), (0, 0), (2, 0)):
        want = jpipe.make_batch(jcfg, step, rank)
        got = tpipe.make_batch(tcfg, step, rank)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "stats":
                racy = ("plan_cache_hit_rate",) \
                    if knobs["planner_workers"] > 1 else ()
                assert {n: x for n, x in got[k].items() if n not in racy} \
                    == {n: x for n, x in want[k].items() if n not in racy}
            else:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cache = tpipe._planner_state(tcfg)[2]
    if "buf_len" in knobs:
        assert got["send_idx"].shape[-1] == knobs["buf_len"]
        assert cache is None
    else:
        assert cache.granularity == knobs.get("cache_granularity", 1)
        assert cache.max_entries == knobs["cache_entries"]


@pytest.mark.parametrize("strategy", ["flashcp", "llama3", "per_doc",
                                      "ring_zigzag", "contiguous", "bnb"])
def test_workload_accounting_matches_reference(strategy):
    """Every function of ``core/workload.py`` on random plans equals the
    reference's."""
    for seed in range(4):
        N = (2, 3, 4, 4)[seed]
        lens = _mix(40 + seed, 1536, 5 + seed)
        jp = jpl.get_planner(strategy)(lens, N)
        tp = tpl.get_planner(strategy)(lens, N)
        for fn in ("comm_tokens_flashcp", "comm_saving"):
            assert getattr(twork, fn)(tp) == getattr(jwork, fn)(jp), fn
        for kw in ({}, {"dtype_bytes": 1, "fwd_and_bwd": False}):
            assert twork.plan_comm_bytes(tp, 2, 128, **kw) == \
                jwork.plan_comm_bytes(jp, 2, 128, **kw)
            assert twork.comm_bytes(tp.comm_tokens(), N, 8, 64, **kw) == \
                jwork.comm_bytes(jp.comm_tokens(), N, 8, 64, **kw)
        assert twork.comm_tokens_static(1536, N) == \
            jwork.comm_tokens_static(1536, N)
        assert twork.total_workload(lens) == jwork.total_workload(lens)
        for p, s in ((0, 17), (100, 1), (7, 300)):
            assert twork.shard_workload(p, s) == jwork.shard_workload(p, s)
        assert twork.causal_doc_workload(int(lens[0])) == \
            jwork.causal_doc_workload(int(lens[0]))
