"""The port's copy of the planning stack (``repro_torch.planner``)
against the reference's ``repro.planner``, bit for bit: for every
registered strategy x dataset x CP size {2, 4, 8}, the plans shard for
shard, ``validate_plan``'s verdicts, ``encode_plan_batch``'s arrays, the
plan cache's plans and statistics, and the registry's metadata; and the
port's serial planning against the reference's planner thread pool.
"""

import dataclasses

import numpy as np
import pytest

import repro.planner as jpl
from repro.data.distributions import DATASETS
from repro.data.packing import pack_sequence
from repro_torch import planner as tpl
from repro_torch.data.distributions import make_rng

CP_SIZES = (2, 4, 8)
CONTEXT = 4096


def _lens_list(dataset: str, seed: int, n: int = 4):
    rng = make_rng(seed)
    return [pack_sequence(dataset, CONTEXT, rng) for _ in range(n)]


def _same_plan(a, b, what=""):
    assert type(a).__name__ == type(b).__name__
    for f in ("doc_id", "start", "length", "worker"):
        x, y = getattr(a.arrays, f), getattr(b.arrays, f)
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")
    np.testing.assert_array_equal(a.doc_lens, b.doc_lens)
    assert (a.num_workers, a.comm_style) == (b.num_workers, b.comm_style)
    assert a.comm_tokens() == b.comm_tokens()
    assert a.imbalance_ratio() == b.imbalance_ratio()
    assert a.describe() == b.describe()


def _verdict(validate, plan, **kw):
    try:
        validate(plan, **kw)
        return None
    except AssertionError as e:
        return str(e)


def _same_stack(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("N", CP_SIZES)
@pytest.mark.parametrize("strategy", tpl.available_planners())
def test_planner_copy_matches_reference(strategy, N):
    for dataset in sorted(DATASETS):
        lens_list = _lens_list(dataset, seed=N)
        jplans = [jpl.get_planner(strategy)(lens, N) for lens in lens_list]
        tplans = [tpl.get_planner(strategy)(lens, N) for lens in lens_list]
        for jp, tp in zip(jplans, tplans):
            _same_plan(jp, tp, f"{strategy}/{dataset}/N{N}")
            for kw in ({}, {"require_equal_tokens": False},
                       {"token_tolerance": N}):
                assert _verdict(jpl.validate_plan, jp, **kw) == \
                    _verdict(tpl.validate_plan, tp, **kw)
        # a broken plan: both refuse it, with the same message
        jp, tp = jplans[0], tplans[0]
        for plan in (jp, tp):
            plan.arrays.length[0] += 1
        assert _verdict(jpl.validate_plan, jp) == \
            _verdict(tpl.validate_plan, tp) is not None
        for plan in (jp, tp):
            plan.arrays.length[0] -= 1
        for align in (1, 64):
            jst, jenc = jpl.encode_plan_batch(jplans, align=align)
            tst, tenc = tpl.encode_plan_batch(tplans, align=align)
            _same_stack(jst, tst)
            for a, b in zip(jenc, tenc):
                assert (a.t_loc, a.buf_len, a.comm_tokens, a.imbalance) == \
                    (b.t_loc, b.buf_len, b.comm_tokens, b.imbalance)
            for jp, tp in zip(jplans, tplans):
                assert jpl.plan_shape_hints(jp, align=align) == \
                    tpl.plan_shape_hints(tp, align=align)


@pytest.mark.parametrize("N", CP_SIZES)
def test_flashcp_heuristic_and_helpers_match(N):
    for dataset in sorted(DATASETS):
        for lens in _lens_list(dataset, seed=10 + N, n=3):
            for ratio in (1.0, 1.05, 1.5):
                jp, js = jpl.flashcp_plan(lens, N, target_ratio=ratio)
                tp, ts = tpl.flashcp_plan(lens, N, target_ratio=ratio)
                _same_plan(jp, tp)
                assert dataclasses.asdict(js) == dataclasses.asdict(ts)
            d = int(lens.max())
            assert jpl.zigzag_doc_shards(0, d, N) == \
                [jpl.Shard(*dataclasses.astuple(s))
                 for s in tpl.zigzag_doc_shards(0, d, N)]
    shards = [(0, 0, 5, 1), (0, 5, 3, 1), (1, 0, 4, 0), (0, 8, 2, 0)]
    assert [dataclasses.astuple(s) for s in jpl.merge_adjacent_shards(
        jpl.Shard(*s) for s in shards)] == \
        [dataclasses.astuple(s) for s in tpl.merge_adjacent_shards(
            tpl.Shard(*s) for s in shards)]
    _same_plan(jpl.make_whole_doc_plan([5, 9, 2], [1, 0, 1], 2),
               tpl.make_whole_doc_plan([5, 9, 2], [1, 0, 1], 2))
    _same_plan(jpl.trivial_plan(640), tpl.trivial_plan(640))
    np.testing.assert_array_equal(jpl.shard_workload_array([0, 7], [5, 3]),
                                  tpl.shard_workload_array([0, 7], [5, 3]))


@pytest.mark.parametrize("N", CP_SIZES)
@pytest.mark.parametrize("strategy", tpl.available_planners())
def test_plan_cache_copy_matches_reference(strategy, N):
    """The same stream of length mixes — repeats, reorderings (which an
    order-invariant planner's cache canonicalizes) and near-misses (new
    signatures) — through both caches at exact signatures: the same plans
    and the same hit, miss and eviction counts."""
    lens_list = _lens_list("pile", seed=N, n=3)
    stream = []
    for lens in lens_list:
        near = lens.copy()
        near[0] += 8
        near[-1] -= 8
        stream += [lens, lens[::-1].copy(), lens, near]
    for entries in (256, 2):
        jc = jpl.PlanCache(strategy, N, max_entries=entries)
        tc = tpl.PlanCache(strategy, N, max_entries=entries)
        for lens in stream:
            if int(lens.sum()) % (2 * N):
                continue
            _same_plan(jc.plan(lens), tc.plan(lens), f"{strategy} {entries}")
        port = dataclasses.asdict(tc.stats)
        assert {k: v for k, v in dataclasses.asdict(jc.stats).items()
                if k in port} == port
        assert jc.stats.quantized_hits == 0
        assert jc.stats.hit_rate == tc.stats.hit_rate
        assert len(jc) == len(tc)


def test_registry_metadata_matches_reference():
    """Every planner of the reference is registered in the port, under
    the same names and aliases (the exact branch-and-bound planner as
    ``bnb``/``ilp`` too), with the reference's metadata."""
    ported = tpl.available_planners(include_aliases=True)
    assert jpl.available_planners(include_aliases=True) == ported
    assert jpl.available_planners() == tpl.available_planners()
    for name in ported:
        assert dataclasses.asdict(jpl.planner_info(name)) == \
            dataclasses.asdict(tpl.planner_info(name)), name
    for family in ("dense", "moe", "hybrid", "ssm"):
        assert jpl.planners_for_family(family) == \
            tpl.planners_for_family(family)
    with pytest.raises(KeyError, match="available"):
        tpl.get_planner("nope")
    with pytest.raises(ValueError, match="already registered"):
        tpl.register_planner("flashcp")(lambda *a, **k: None)


@pytest.mark.parametrize("workers", [1, 3])
def test_serial_planning_matches_reference_pool(workers):
    """The port plans and encodes a batch one sequence after the other;
    the reference's thread pool of ``workers`` gives the same plans and
    the same stacked arrays."""
    lens_list = _lens_list("wlb_llm", seed=5, n=5)
    jplans = jpl.plan_many(lambda l: jpl.get_planner("flashcp")(l, 4),
                           lens_list, workers=workers)
    tplans = [tpl.get_planner("flashcp")(l, 4) for l in lens_list]
    for x, y in zip(jplans, tplans):
        _same_plan(x, y)
    jst, _ = jpl.encode_plan_batch(jplans, align=128, workers=workers)
    tst, _ = tpl.encode_plan_batch(tplans, align=128)
    _same_stack(jst, tst)
