"""Adaptive DP x CP dispatch in the port against the JAX package.

* The dispatcher's host logic (``repro_torch.dispatch``, a copy of
  ``repro.dispatch``) decides bit for bit as the reference does on
  seeded pools, with and without straggler device speeds.
* ``make_dispatch_batch`` (pool, degree, group-major rows, plans pinned
  to ``t_loc = C / cp``, content-keyed tokens, visit tables) is the
  reference's bit for bit at 2x2 and 1x4, and so is the batch encoding
  at a pinned ``t_loc``; the ``Prefetcher`` yields the same stream.
* The loop: the port's ``--mesh 2x2 --dispatch`` (4 gloo ranks, ZeRO-3,
  a reshard at every degree switch) against the reference's ``train()``
  with the same flags on 4 simulated host devices, from one checkpoint:
  the same degrees and losses to 1e-4 (f32 sums in other orders); and
  against its own 1x1 run of the same dispatched stream, which packs
  alike at every degree (``--dispatch-bin-quantum 2``): 1e-4.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import repro.dispatch as jd
from repro.data.packing import sample_doc_pool as jpool
from repro.data.pipeline import (PipelineConfig as JPipe,
                                 make_dispatch_batch as jbatch)
from repro.data.distributions import make_rng as jrng
from repro.planner import encode_plan_batch as jencode, get_planner as jget
import repro_torch.dispatch as td
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import (PipelineConfig as TPipe, Prefetcher,
                                       make_dispatch_batch as tbatch)
from repro_torch.launch.train import main
from repro_torch.planner import (encode_plan_batch as tencode,
                                 get_planner as tget)
from _torch_elastic_ranks import SMOKE, reference_train, seed_checkpoint

torch.set_num_threads(1)


def _same(a, b, what=""):
    """Exact equality of nested plan fields (arrays, lists, dicts)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)) and a and isinstance(
            a[0], (np.ndarray, dict, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _plan_fields(p):
    return {f.name: (p.profile.as_dict() if f.name == "profile"
                     else getattr(p, f.name))
            for f in dataclasses.fields(p)}


@pytest.mark.parametrize("seed", range(4))
def test_balance_and_profile_copies_match(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 3000, 40)
    a, b = jd.profile_lengths(lens, tail_len=512), \
        td.profile_lengths(lens, tail_len=512)
    assert a.as_dict() == b.as_dict()
    assert jd.sequence_workload(lens) == td.sequence_workload(lens)
    targets = rng.integers(500, 4096, 4)
    for kw in ({}, {"quantum": 16}, {"quantum": 4, "targets": targets}):
        pa, pb = jd.pack_pool(lens, 4, 4096, **kw), \
            td.pack_pool(lens, 4, 4096, **kw)
        _same({f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)},
              {f.name: getattr(pb, f.name) for f in dataclasses.fields(pb)})
    w = rng.random(8)
    speeds = rng.uniform(0.3, 1.0, 4)
    for kw in ({}, {"per_group": 2}, {"per_group": 2, "speeds": speeds}):
        np.testing.assert_array_equal(jd.lpt_assign(w, 4, **kw),
                                      td.lpt_assign(w, 4, **kw))
    assert jd.imbalance(w) == td.imbalance(w)
    assert jd.effective_imbalance(w[:4], speeds) == \
        td.effective_imbalance(w[:4], speeds)
    assert jd.estimate_comm_tokens(lens, 4, 8192) == \
        td.estimate_comm_tokens(lens, 4, 8192)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mesh,seqs", [((2, 2), 4), ((1, 4), 4),
                                       ((2, 4), 8), ((4, 2), 8)])
@pytest.mark.parametrize("speeds", [False, True])
def test_dispatch_step_bit_for_bit(seed, mesh, seqs, speeds):
    """Seeded wlb_llm and pile pools through both dispatchers: every
    field of the plan, and every admissible degree, equal."""
    D, M = mesh
    C = 2048
    for dataset in ("wlb_llm", "pile"):
        pool = jpool(dataset, seqs * C, jrng(100 * seed + D * M),
                     max_doc_len=C, min_docs=seqs)
        dev = np.random.default_rng(seed).uniform(0.4, 1.0, D * M) \
            if speeds else None
        kw = dict(data=D, model=M, seqs=seqs, quantum=16)
        a = jd.dispatch_step(pool, jd.DispatchConfig(**kw), C,
                             device_speeds=dev)
        b = td.dispatch_step(pool, td.DispatchConfig(**kw), C,
                             device_speeds=dev)
        _same(_plan_fields(a), _plan_fields(b), dataset)
        for extra in ({}, {"min_cp": 2}, {"fixed_cp": M}):
            assert jd.cp_degree_options(jd.DispatchConfig(**kw, **extra),
                                        C) == \
                td.cp_degree_options(td.DispatchConfig(**kw, **extra), C)
    # an odd context splits over no degree above 1
    bad = td.DispatchConfig(data=D, model=M, seqs=seqs, fixed_cp=M)
    assert td.cp_degree_options(bad, C + 1, strict=False) == []
    with pytest.raises(ValueError, match="inadmissible"):
        td.cp_degree_options(bad, C + 1)


def _pipes(mesh, **kw):
    base = dict(dataset="wlb_llm", context_len=1024, batch_per_host=4,
                cp_size=mesh[1], strategy="flashcp", vocab_size=512,
                seed=0, align=16)
    base.update(kw)
    return JPipe(**base), TPipe(**base)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("tables", [False, True])
def test_make_dispatch_batch_bit_for_bit(mesh, tables):
    """Six steps of the global stream at 2x2 and 1x4 (degrees change
    step to step), with and without visit tables, and one step placed
    under device speeds: every key bit for bit, the dispatch stats
    equal."""
    kw = dict(emit_tables=True, table_block_q=16, table_block_k=16) \
        if tables else {}
    jp, tp = _pipes(mesh, **kw)
    dk = dict(data=mesh[0], model=mesh[1], seqs=4, quantum=16)
    degrees = []
    for step in range(6):
        speeds = np.asarray([1.0, 0.5, 1.0, 0.8]) if step == 5 else None
        a = jbatch(jp, jd.DispatchConfig(**dk), step, device_speeds=speeds)
        b = tbatch(tp, td.DispatchConfig(**dk), step, device_speeds=speeds)
        assert sorted(a) == sorted(b)
        for k in a:
            if k != "stats":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        _same(a["stats"]["dispatch"], b["stats"]["dispatch"])
        assert a["stats"]["t_loc"] == b["stats"]["t_loc"] \
            == 1024 // b["stats"]["dispatch"]["cp_degree"]
        degrees.append(b["stats"]["dispatch"]["cp_degree"])
    assert len(set(degrees)) > 1, degrees


def test_encode_plan_batch_pinned_t_loc_matches_reference():
    lens = [np.asarray(x) for x in ([300, 200, 12], [500, 12], [256] * 2)]
    for name in ("flashcp", "llama3"):
        jplans = [jget(name)(x, 2) for x in lens]
        tplans = [tget(name)(x, 2) for x in lens]
        for t_loc in (None, 512, 640):
            a, _ = jencode(jplans, t_loc=t_loc, align=16)
            b, _ = tencode(tplans, t_loc=t_loc, align=16)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dispatch_prefetcher_and_plan_cache():
    """The dispatch ``Prefetcher`` yields ``make_dispatch_batch`` from its
    start step (speeds sampled per batch); a pipeline config with
    another target imbalance has its own plan cache, and a replayed
    stream hits it."""
    _, tp = _pipes((2, 2))
    dcfg = td.DispatchConfig(data=2, model=2, seqs=4, quantum=16)
    pf = Prefetcher(tp, start_step=2, dispatch=dcfg,
                    speeds_fn=lambda: None)
    try:
        for step in (2, 3):
            got, want = next(pf), tbatch(tp, dcfg, step)
            for k in want:
                if k != "stats":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    other = dataclasses.replace(tp, target_imbalance=1.07)
    assert tpipe._planner_state(tp)[2] is tpipe._planner_state(
        dataclasses.replace(tp))[2]
    assert tpipe._planner_state(other)[2] is not \
        tpipe._planner_state(tp)[2]
    g = tbatch(other, dcfg, 0)["stats"]["dispatch"]["cp_degree"]
    cache = tpipe._planner_state(dataclasses.replace(other, cp_size=g))[2]
    hits = cache.stats.hits
    tbatch(other, dcfg, 0)
    assert cache.stats.hits > hits


def _losses(out: str) -> list[float]:
    return [float(line.split()[4]) for line in out.splitlines()
            if line.startswith("[train] step")]


def _degrees(out: str) -> list[int]:
    return [int(line.split()[line.split().index("cp") + 1])
            for line in out.splitlines() if line.startswith("[train] step")]


SEQ, BATCH, STEPS = 1024, 4, 6


def test_dispatch_loop_matches_reference_train(capfd, tmp_path):
    """``--mesh 2x2 --dispatch``: the port (4 gloo ranks) and the
    reference's ``train()`` (4 simulated host devices) resume one
    checkpoint and train to step 6: the same CP degrees (switching at
    least once) and the same losses to 1e-4."""
    seed_checkpoint(main, tmp_path / "port", SEQ, BATCH)
    capfd.readouterr()
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ref = reference_train(tmp_path / "ref", 4, mesh="2x2", seq_len=SEQ,
                          batch=BATCH, steps=STEPS, ckpt_every=0,
                          dispatch=True)
    main(SMOKE + ["--seq-len", str(SEQ), "--batch", str(BATCH), "--steps",
                  str(STEPS), "--mesh", "2x2", "--dist-backend", "gloo",
                  "--dispatch", "--checkpoint-dir", str(tmp_path / "port"),
                  "--resume"])
    out = capfd.readouterr().out
    assert "[train] resumed from step 1" in out
    assert len(ref["losses"]) == STEPS - 1
    np.testing.assert_allclose(_losses(out), ref["losses"], rtol=1e-4)
    deg = _degrees(out)
    assert len(set(deg)) > 1, deg
    assert f"dispatch: {ref['degree_switches']} degree switches" in out


def test_dispatch_loop_matches_one_rank_on_the_same_stream(capfd):
    """The same dispatched stream (bins packed alike at every degree)
    through ``--mesh 2x2`` and ``--mesh 1x1``: the data do not depend on
    the degree, so the losses agree to 1e-4."""
    argv = SMOKE + ["--seq-len", str(SEQ), "--batch", str(BATCH),
                    "--steps", "4", "--dispatch",
                    "--dispatch-bin-quantum", "2"]
    main(argv)
    one = capfd.readouterr().out
    main(argv + ["--mesh", "2x2", "--dist-backend", "gloo"])
    four = capfd.readouterr().out
    assert len(set(_degrees(four))) > 1 and set(_degrees(one)) == {1}
    np.testing.assert_allclose(_losses(four), _losses(one), rtol=1e-4)


def test_group_meshes_tile_the_ranks(tmp_path):
    """Every degree's mesh over the 2x2 ranks, and over a subset of
    them: the shapes, each rank's coordinates, and None outside."""
    import _torch_elastic_ranks as ranks
    from repro_torch.launch.ranks import spawn_ranks

    spawn_ranks(ranks.mesh_rank, 4, args=(4, str(tmp_path / "store"),
                                          str(tmp_path)), timeout=120)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for r, res in enumerate(got):
        # degree 1 -> (4, 1): rank r at (r, 0); degree 2 -> (2, 2)
        assert res["g1"].tolist() == [4, 1, r, 0]
        assert res["g2"].tolist() == [2, 2, r // 2, r % 2]
        # ranks [1, 3] as a 1x2 grid; ranks 0 and 2 are outside
        assert res["sub"].tolist() == ([1, 2, 0, [1, 3].index(r)]
                                       if r in (1, 3) else [-1])
        if r in (1, 3):
            assert res["sub_sum"].tolist() == [4.0]
