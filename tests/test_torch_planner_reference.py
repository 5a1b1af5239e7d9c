"""The port's golden planner spec (``repro_torch.planner.reference``).

Two checks, on the cases of the reference's own golden-parity tests
(``tests/test_planner_registry.py``): wlb_llm, pile and redpajama at CP
2, 4 and 8 with three draws from ``make_rng(17)``; flashcp across six
seeds at 32768 tokens and CP 8; the encoder, single and batched.

* The port's copy equals ``repro.planner.reference`` bit for bit: the
  shards in order, every accounting method, ``ref_validate_plan``'s
  verdict and every encoding array with its dtype.
* The port's registry planners match the port's copy shard for shard, as
  a mirror of the reference's tests against its own copy.
"""

import dataclasses

import numpy as np
import pytest

from repro.planner import reference as jref
from repro_torch.data.distributions import make_rng
from repro_torch.data.packing import pack_sequence
from repro_torch.planner import (encode_plan, encode_plan_batch,
                                 flashcp_plan, get_planner, validate_plan)
from repro_torch.planner import reference as tref

DATASETS = ("wlb_llm", "pile", "redpajama")
CP_SIZES = (2, 4, 8)
STRATEGIES = ("flashcp", "llama3", "per_doc", "ring_zigzag", "contiguous")
ENC_FIELDS = ("perm", "doc", "pos", "send_idx", "gath_doc", "gath_pos")


def _draws(dataset, seed=17, n=3, context=16384):
    rng = make_rng(seed)
    return [pack_sequence(dataset, context, rng) for _ in range(n)]


def _key(plan):
    return sorted((int(s.doc_id), int(s.start), int(s.length), int(s.worker))
                  for s in plan.shards)


def _ref_key(plan):
    return sorted((s.doc_id, s.start, s.length, s.worker)
                  for s in plan.shards)


def _verdict(plan, validate, **kw):
    try:
        validate(plan, **kw)
        return None
    except AssertionError as e:
        return str(e)


def _same_ref_plan(t, j):
    """The port's ``RefShardingPlan`` against the reference's, bit for
    bit: shards in emission order, every accounting method's value and
    dtype, and the validator's verdict."""
    assert [dataclasses.astuple(s) for s in t.shards] == \
        [dataclasses.astuple(s) for s in j.shards]
    np.testing.assert_array_equal(t.doc_lens, j.doc_lens)
    assert (t.num_workers, t.comm_style) == (j.num_workers, j.comm_style)
    for m in ("tokens_per_worker", "workload_per_worker",
              "nonlast_tokens_per_worker"):
        a, b = getattr(t, m)(), getattr(j, m)()
        assert a.dtype == b.dtype, m
        np.testing.assert_array_equal(a, b, err_msg=m)
    assert t.comm_tokens() == j.comm_tokens()
    assert t.imbalance_ratio() == j.imbalance_ratio()
    assert _verdict(t, tref.ref_validate_plan) == \
        _verdict(j, jref.ref_validate_plan)


def _same_encoding(t, j):
    for f in ENC_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (t.t_loc, t.buf_len, t.comm_tokens, t.imbalance) == \
        (j.t_loc, j.buf_len, j.comm_tokens, j.imbalance)


def test_golden_copy_has_the_references_names():
    assert tref.__all__ == jref.__all__
    assert sorted(tref.REFERENCE_PLANNERS) == sorted(jref.REFERENCE_PLANNERS)


# --------------------------------------------------------------------- #
# the port's golden copy == the reference's, bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("cp", CP_SIZES)
def test_golden_copy_matches_reference(dataset, cp):
    for lens in _draws(dataset):
        for name in sorted(jref.REFERENCE_PLANNERS):
            t = tref.REFERENCE_PLANNERS[name](lens, cp)
            j = jref.REFERENCE_PLANNERS[name](lens, cp)
            _same_ref_plan(t, j)
            _same_encoding(tref.ref_encode_plan(t, align=16),
                           jref.ref_encode_plan(j, align=16))


def test_golden_flashcp_matches_reference_across_seeds():
    for seed in range(6):
        lens = pack_sequence("wlb_llm", 32768, make_rng(seed))
        _same_ref_plan(tref.ref_flashcp_plan(lens, 8),
                       jref.ref_flashcp_plan(lens, 8))


def test_golden_encoder_matches_reference():
    lens_a, lens_b = _draws("pile", seed=3, n=2)
    t = [tref.ref_flashcp_plan(x, 8) for x in (lens_a, lens_b)]
    j = [jref.ref_flashcp_plan(x, 8) for x in (lens_a, lens_b)]
    _same_encoding(tref.ref_encode_plan(t[0], align=16),
                   jref.ref_encode_plan(j[0], align=16))
    s_t, e_t = tref.ref_encode_plan_batch(t, align=16)
    s_j, e_j = jref.ref_encode_plan_batch(j, align=16)
    assert sorted(s_t) == sorted(s_j)
    for k in s_j:
        assert s_t[k].dtype == s_j[k].dtype, k
        np.testing.assert_array_equal(s_t[k], s_j[k], err_msg=k)
    for a, b in zip(e_t, e_j):
        _same_encoding(a, b)


def test_golden_validator_verdicts_match_reference():
    """A broken plan (a shard moved to another worker) draws the same
    verdict from both copies, with and without the token check."""
    lens = _draws("wlb_llm", n=1)[0]
    broken = []
    for mod in (tref, jref):
        plan = mod.ref_llama3_plan(lens, 4)
        s = plan.shards[0]
        plan.shards[0] = mod.RefShard(s.doc_id, s.start, s.length,
                                      (s.worker + 1) % 4)
        broken.append(plan)
    for kw in ({}, {"require_equal_tokens": False}, {"token_tolerance": 64}):
        assert _verdict(broken[0], tref.ref_validate_plan, **kw) == \
            _verdict(broken[1], jref.ref_validate_plan, **kw)


# --------------------------------------------------------------------- #
# the port's registry planners == the port's golden copy
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("cp", CP_SIZES)
def test_planners_match_golden_copy(dataset, cp):
    for lens in _draws(dataset):
        for name in STRATEGIES:
            plan = get_planner(name)(lens, cp)
            seed = tref.REFERENCE_PLANNERS[name](lens, cp)
            assert _key(plan) == _ref_key(seed), \
                f"{name} diverged from the golden copy on {dataset}/cp{cp}"
            assert plan.comm_style == seed.comm_style
            assert plan.comm_tokens() == seed.comm_tokens()
            np.testing.assert_array_equal(plan.tokens_per_worker(),
                                          seed.tokens_per_worker())
            assert plan.imbalance_ratio() == \
                pytest.approx(seed.imbalance_ratio())


def test_flashcp_matches_golden_copy_across_seeds():
    for seed in range(6):
        lens = pack_sequence("wlb_llm", 32768, make_rng(seed))
        plan, _ = flashcp_plan(lens, 8)
        assert _key(plan) == _ref_key(tref.ref_flashcp_plan(lens, 8))
        validate_plan(plan, token_tolerance=8)


def test_encoding_matches_golden_encoder():
    lens_a, lens_b = _draws("pile", seed=3, n=2)
    new = [flashcp_plan(x, 8)[0] for x in (lens_a, lens_b)]
    old = [tref.ref_flashcp_plan(x, 8) for x in (lens_a, lens_b)]
    e_new = encode_plan(new[0], align=16)
    e_old = tref.ref_encode_plan(old[0], align=16)
    for f in ENC_FIELDS:
        np.testing.assert_array_equal(getattr(e_new, f), getattr(e_old, f),
                                      err_msg=f)
    assert (e_new.t_loc, e_new.buf_len, e_new.comm_tokens) == \
        (e_old.t_loc, e_old.buf_len, e_old.comm_tokens)
    s_new, _ = encode_plan_batch(new, align=16)
    s_old, _ = tref.ref_encode_plan_batch(old, align=16)
    for k in s_new:
        np.testing.assert_array_equal(s_new[k], s_old[k], err_msg=k)
        assert s_new[k].dtype == s_old[k].dtype
