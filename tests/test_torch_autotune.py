"""The port's cost-model autotuner (``repro_torch.autotune``) against the
reference's (``repro.autotune``), bit for bit, with the reference's cost
constants (``hw=`` its ``HW``, and its ``L_HALF``) on the port's side.

The two packages name the attention knob differently: the port's
``"flash"`` / ``"plain"`` are the reference's ``"pallas"`` / ``"xla"``
(``TuneProblem.attention_impl``, ``RunConfig.attention_impl``); the
tests map one onto the other.  Every float is computed in the same
order on both sides, so every comparison is exact.

* enumeration: equal candidate keys on ``scripts/flashcheck.py``'s three
  problems and on a dense, a moe and a hybrid family;
* ``predict`` and ``measure_candidate``: equal ``CostEstimate`` fields on
  every candidate of a 1x2 and a 2x2 problem;
* ``tune``: equal best, frontier, ``spearman_frontier`` and
  ``n_candidates``; ``autotune_run`` on a smoke starcoder2_3b: an equal
  tuned RunConfig;
* the result cache: a round trip, a second ``tune`` served from it, and
  the port's signature without ``"hw"`` equal to the reference's (so the
  port's keys differ from the reference's only by the constants);
* ``train.py --autotune --autotune-dry`` returns the pick, spawns nothing;
* the port's ``HW`` is the H100's, not the reference's;
* the monotone cost primitives on fixed seeds (0-63 and the three seeds
  where the reference's hypothesis test trips over a rounding of 1e-18),
  with a tolerance of a few ulps relative to the operands.
"""

import dataclasses
import json
import socket

import numpy as np
import pytest

import repro.autotune as J
import repro.autotune.cost_model as jcm
import repro.configs as jcfg
import repro_torch.autotune as T
import repro_torch.autotune.cost_model as tcm
import repro_torch.configs as tcfg
from repro_torch.launch import train as ttrain
from repro_torch.launch.ranks import spawn_ranks

IMPL = {"flash": "pallas", "plain": "xla"}
HW = dict(jcm.HW)
DIMS_KW = dict(num_heads=4, kv_heads=2, head_dim=32, d_model=128, d_ff=512)


@pytest.fixture(autouse=True)
def reference_l_half(monkeypatch):
    """The port's cost model on the reference's half-saturation length
    (the ``hw=`` argument carries the rest of the constants)."""
    monkeypatch.setattr(tcm, "L_HALF", jcm.L_HALF)


def _problems(**kw):
    """(port TuneProblem, reference TuneProblem) of ``kw`` (the port's
    attention_impl names)."""
    ref = dict(kw)
    if "attention_impl" in kw:
        ref["attention_impl"] = IMPL[kw["attention_impl"]]
    return T.TuneProblem(**kw), J.TuneProblem(**ref)


def _pool(seed=0, n=24, lo=16, hi=200):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int64)


ENUM_PROBLEMS = [
    # scripts/flashcheck.py's three
    dict(data=1, model=2, context_len=512, seqs=2, quantum=1,
         attention_impl="plain"),
    dict(data=1, model=2, context_len=1024, seqs=2, quantum=128,
         attention_impl="flash"),
    dict(data=1, model=4, context_len=2048, seqs=2, quantum=128,
         attention_impl="flash", family="hybrid"),
    # a dense, a moe and a hybrid family on a 2x2 mesh
    dict(data=2, model=2, context_len=1024, seqs=4, quantum=128,
         attention_impl="flash", family="dense"),
    dict(data=2, model=2, context_len=1024, seqs=4, quantum=16,
         attention_impl="plain", family="moe"),
    dict(data=1, model=4, context_len=4096, seqs=2, quantum=16,
         attention_impl="plain", family="hybrid"),
]


@pytest.mark.parametrize("kw", ENUM_PROBLEMS,
                         ids=[f"p{i}" for i in range(len(ENUM_PROBLEMS))])
def test_enumeration_matches_reference(kw):
    tp, jp = _problems(**kw)
    got = [c.key() for c in T.enumerate_candidates(tp)]
    want = [c.key() for c in J.enumerate_candidates(jp)]
    assert got == want and got
    for c in T.enumerate_candidates(tp):
        assert T.candidate_degrees(c, tp) == J.candidate_degrees(
            J.Candidate(**c.as_dict()), jp)


SCORE_PROBLEMS = [
    dict(data=1, model=2, context_len=1024, seqs=2, quantum=128,
         attention_impl="flash"),
    dict(data=2, model=2, context_len=1024, seqs=4, quantum=16,
         attention_impl="plain"),
]


@pytest.mark.parametrize("kw", SCORE_PROBLEMS, ids=["1x2", "2x2"])
def test_predict_and_measure_match_reference(kw):
    tp, jp = _problems(**kw)
    pool = _pool(3, n=32)
    tdims, jdims = T.ModelDims(**DIMS_KW), J.ModelDims(**DIMS_KW)
    cands = T.enumerate_candidates(tp)
    assert len(cands) > 20
    for c in cands:
        jc = J.Candidate(**c.as_dict())
        assert T.predict(c, pool, tp, tdims, hw=HW).as_dict() == \
            J.predict(jc, pool, jp, jdims).as_dict(), c
        assert T.measure_candidate(c, pool, tp, tdims, hw=HW).as_dict() == \
            J.measure_candidate(jc, pool, jp, jdims).as_dict(), c


@pytest.mark.parametrize("kw", SCORE_PROBLEMS, ids=["1x2", "2x2"])
def test_tune_matches_reference(kw):
    tp, jp = _problems(**kw)
    pool = _pool(5)
    got = T.tune(pool, tp, T.ModelDims(**DIMS_KW), top_k=6, hw=HW)
    want = J.tune(pool, jp, J.ModelDims(**DIMS_KW), top_k=6)
    assert got.best.as_dict() == want.best.as_dict()
    assert got.frontier == want.frontier
    assert got.candidates == want.candidates
    assert got.spearman_frontier == want.spearman_frontier
    assert got.n_candidates == want.n_candidates
    assert got.best_measured == want.best_measured


def test_autotune_run_matches_reference():
    """The tuned RunConfig of a smoke starcoder2_3b at 1x2 (the
    reference's base run writing no checkpoints, as the port's)."""
    kw = dict(data=1, model=2, context_len=1024, seqs=2)
    trun, tres = T.autotune_run(
        tcfg.RunConfig(arch="starcoder2_3b", attention_impl="flash"),
        tcfg.reduce_for_smoke(tcfg.get_config("starcoder2_3b")), hw=HW,
        **kw)
    jrun, jres = J.autotune_run(
        jcfg.RunConfig(arch="starcoder2_3b", attention_impl="pallas",
                       checkpoint_dir=""),
        jcfg.reduce_for_smoke(jcfg.get_config("starcoder2_3b")), **kw)
    got = tcfg.run_config_to_dict(trun)
    want = jcfg.run_config_to_dict(jrun)
    assert got["attention_impl"] == "flash"
    assert {**got, "attention_impl": "pallas"} == \
        {k: want[k] for k in got}
    assert tres.best.as_dict() == jres.best.as_dict()
    assert tres.frontier == jres.frontier
    assert tcfg.run_config_from_dict({**got, "unknown": 1}) == trun


def _signature(pkg, kw, pool, hw=None):
    problem = pkg.TuneProblem(**kw)
    dims = pkg.ModelDims(**DIMS_KW)
    if hw is None:
        return pkg.tune_signature(problem, dims, pool, pkg.DEFAULT_SPACE)
    return pkg.tune_signature(problem, dims, pool, pkg.DEFAULT_SPACE, hw)


def test_signature_is_the_references_plus_hw():
    tp, jp = _problems(**SCORE_PROBLEMS[0])
    pool = _pool(9)
    got = _signature(T, dataclasses.asdict(tp), pool, HW)
    want = _signature(J, dataclasses.asdict(jp), pool)
    assert got.pop("hw") == HW
    got["problem"]["attention_impl"] = IMPL[got["problem"]["attention_impl"]]
    assert got == want
    # the H100's constants give another key than the reference's
    assert T.signature_key(_signature(T, dataclasses.asdict(tp), pool)) != \
        T.signature_key(_signature(T, dataclasses.asdict(tp), pool, HW))


def test_cache_round_trip_and_hit(tmp_path):
    tp, _ = _problems(**SCORE_PROBLEMS[0])
    pool = _pool(11)
    dims = T.ModelDims(**DIMS_KW)
    cache = T.ResultCache(tmp_path)
    first = T.tune(pool, tp, dims, top_k=4, cache=cache, hw=HW)
    assert not first.cached and cache.misses == 1
    again = T.tune(pool, tp, dims, top_k=4, cache=cache, hw=HW)
    assert again.cached and cache.hits == 1
    assert again.to_json() == first.to_json()
    assert again.run_config == first.run_config
    # other constants, another entry
    other = T.tune(pool, tp, dims, top_k=4, cache=cache)
    assert not other.cached and other.key != first.key
    assert len(list(tmp_path.glob("tune_*.json"))) == 2


def test_train_autotune_dry_returns_the_pick(tmp_path):
    """``--autotune-dry`` on a 1x2 mesh tunes once, before any rank would
    start, and returns the pick without training; a second call hits the
    cache with the same pick."""
    argv = ["--smoke", "--device", "cpu", "--mesh", "1x2", "--seq-len",
            "512", "--batch", "2", "--autotune", "--autotune-dry",
            "--autotune-cache", str(tmp_path)]
    out = ttrain.main(argv)
    assert out["losses"] == [] and out["final_step"] == 0
    best = out["autotune"]["best"]
    assert not out["autotune"]["cached"]
    assert {k: out["run_config"][k] for k in ttrain.TUNED_KNOBS} == best
    again = ttrain.main(argv)
    assert again["autotune"]["cached"] and again["autotune"]["best"] == best


def test_train_autotune_trains_with_the_pick(tmp_path):
    """``--autotune`` at one rank on the CPU: the run trains with the
    pick's knobs."""
    out = ttrain.main(["--smoke", "--device", "cpu", "--seq-len", "256",
                       "--batch", "1", "--steps", "2", "--autotune",
                       "--autotune-cache", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    run = out["run"]
    for k in ttrain.TUNED_KNOBS:
        assert getattr(run, k) == out["run_config"][k], k


def test_train_autotune_under_env_tunes_on_rank_0(tmp_path):
    """Two processes started with the launcher's variables (env://, each
    one rank): rank 0 tunes, both train with its pick, the one the
    launcher-side tuner gives, and reach the same losses."""
    import _torch_wire_ranks as wr

    argv = ["--smoke", "--device", "cpu", "--seq-len", "256", "--batch",
            "2", "--q-chunk", "64", "--steps", "2", "--mesh", "1x2",
            "--dist-backend", "gloo", "--autotune"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spawn_ranks(wr.train_env_rank, 2, args=(2, port, str(tmp_path), argv),
                timeout=240)
    want = ttrain.main([*argv, "--autotune-dry"])["autotune"]["best"]
    losses = [json.loads((tmp_path / f"losses{r}.json").read_text())
              for r in range(2)]
    got = [json.loads((tmp_path / f"autotune{r}.json").read_text())
           for r in range(2)]
    assert losses[0] == losses[1] and len(losses[0]) == 2
    for g in got:
        assert g["autotune"]["best"] == want
        assert g["trained_with"] == want


def test_port_constants_are_the_h100s():
    for k in ("peak_flops", "hbm_bw"):
        assert tcm.HW[k] != jcm.HW[k], k
    assert set(tcm.HW) == set(jcm.HW)
    assert all(v > 0 for v in tcm.HW.values())


def _monotone_case(seed):
    """The reference test's monotone properties of the cost primitives
    (``tests/test_autotune.py::_monotone_case``), with a tolerance of a
    few ulps relative to the operands in place of its absolute 1e-18:
    ``pipeline_exposed`` is ``t_comp - busy``, a difference of two sums
    of up to ~5e-3 s, and rounds by that much (1.3e-18 at seed 1306)."""
    rng = np.random.default_rng(seed)
    a, b = sorted(rng.uniform(0, 1e9, 2))
    assert T.comm_seconds(a) <= T.comm_seconds(b)

    hops = int(rng.integers(1, 6))
    comm = rng.uniform(0, 1e-3, hops)
    comp = rng.uniform(0, 1e-3, hops)
    base = T.pipeline_exposed(comm, comp)
    assert base == J.pipeline_exposed(comm, comp)
    i = int(rng.integers(hops))
    bump = float(rng.uniform(0, 1e-3))
    # 8 ulps of the largest partial sum the schedule forms (the last
    # hop's finish time is at most every comm and compute time summed)
    tol = 8 * np.finfo(np.float64).eps * (comm.sum() + comp.sum() + bump)
    more_comm = comm.copy()
    more_comm[i] += bump
    assert T.pipeline_exposed(more_comm, comp) >= base - tol
    more_comp = comp.copy()
    more_comp[i] += bump
    assert T.pipeline_exposed(comm, more_comp) <= base + tol

    t = float(rng.uniform(0, 1e-2))
    i1, i2 = sorted(rng.uniform(1.0, 3.0, 2))
    assert T.scale_by_imbalance(t, i1) <= T.scale_by_imbalance(t, i2)
    assert T.scale_by_imbalance(t, i1) >= t


@pytest.mark.parametrize("seed", [*range(64), 1306, 1328, 1462])
def test_cost_primitives_monotone(seed):
    _monotone_case(seed)
