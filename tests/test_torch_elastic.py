"""Elastic supervision of the port's training loops against the JAX
package.

* The runtime copies (``repro_torch.runtime.{elastic, fault_tolerance,
  straggler, recovery}`` and the loop's ``_ft_setup`` and
  ``_effective_accum``) give the reference's results on the same inputs:
  parsed specs, topologies, recovery plans, policy verdicts, monitor
  targets and speeds, and whole supervised runs.
* A lost host: the port's ``--mesh 2x2 --hosts 2 --fail-at 3:1`` (4 gloo
  ranks; ranks 2 and 3 leave, 0 and 1 go on as 1x2 with 2 micro-batches
  a step) against the reference's ``train()`` with the same flags on 4
  simulated host devices, with and without ``--dispatch``: the same
  losses to 1e-4 (f32 sums in other orders), mesh (1, 2), accum 2, dead
  hosts [1] and one recovery.
* A transient failure (``--fail-at 3``): the run restarts from its
  latest checkpoint and replays to the same losses as an uninterrupted
  run (1e-6), with and without ``--prefetch``.
* ``--straggle``: every rank reads rank 0's step time, so all ranks make
  the same targets, degrees and placements, and none waits on another.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import repro.runtime as jr
import repro_torch.runtime as tr
from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain
from repro_torch.launch.train import main
from _torch_elastic_ranks import SMOKE, reference_train, seed_checkpoint

torch.set_num_threads(1)


def _supervised(rt, fail_step, fail_hosts, *, num_hosts=4, dph=2, data=2,
                model=4, min_hosts=2, steps=8):
    """The reference test's supervised run in module ``rt``: what ran,
    what the supervisor decided, and the speeds after."""
    topo = rt.HostTopology(num_hosts=num_hosts, devices_per_host=dph)
    mon = rt.StragglerMonitor()
    sup = rt.ElasticSupervisor(topo, rt.FailurePolicy(min_hosts=min_hosts),
                               data=data, model=model, monitor=mon,
                               logger=lambda *_: None)
    inj = rt.FailureInjector(fail_step, fail_hosts)
    sim = rt.StragglerSim({1: 2.0})
    ran, restores = [], []

    def step(s):
        inj.maybe_fail(s)
        ran.append(s)
        sim.observe(mon, 1.0 + 0.01 * s, sup.surviving_hosts())

    def on_restore(action, plan):
        restores.append((action.value, None if plan is None else (
            plan.surviving_hosts, plan.devices, plan.data_axis,
            plan.model_axis, plan.accum_factor)))
        return 3
    try:
        final = sup.run(step, start_step=0, total_steps=steps,
                        on_restore=on_restore)
    except rt.TrainingFailure as e:
        final = f"raised {e}"
    speeds = sup.device_speeds()
    return (final, ran, restores, sorted(sup.dead), sup.current_axes(),
            None if speeds is None else speeds.tolist())


@pytest.mark.parametrize("case", [
    (5, []), (5, [3]), (5, [1, 2, 3]), (2, [0])])
def test_supervisor_copy_matches_reference(case):
    assert _supervised(tr, *case) == _supervised(jr, *case)


def test_runtime_copies_match_reference():
    for spec in (None, "", -1, 7, "12", "12:1,3", "4:0"):
        assert tr.parse_fail_spec(spec) == jr.parse_fail_spec(spec)
    for specs in (None, ["1:2.0"], ["0:1.5", "3:4"]):
        assert tr.parse_straggle_specs(specs) == \
            jr.parse_straggle_specs(specs)
    for bad in (["1"], ["1:0.5"]):
        with pytest.raises(ValueError):
            tr.parse_straggle_specs(bad)
    for alive, model, old in ((8, 4, 2), (6, 2, 4), (3, 1, None), (4, 4, 1)):
        a = tr.shrink_mesh_shape(alive, model_axis=model, old_data_axis=old)
        b = jr.shrink_mesh_shape(alive, model_axis=model, old_data_axis=old)
        assert (a.mesh_shape, a.axis_names, a.accum_factor) == \
            (b.mesh_shape, b.axis_names, b.accum_factor)
    topo = (tr.HostTopology(4, 2), jr.HostTopology(4, 2))
    for dead in ([], [1], [0, 3]):
        for t in topo:
            assert t.surviving_devices(dead) == topo[1].surviving_devices(dead)
        a = tr.replan_after_failure(topo[0], dead, data=2, model=2)
        b = jr.replan_after_failure(topo[1], dead, data=2, model=2)
        assert (a.surviving_hosts, a.devices, a.data_axis, a.accum_factor) \
            == (b.surviving_hosts, b.devices, b.data_axis, b.accum_factor)
    with pytest.raises(ValueError):
        tr.replan_after_failure(topo[0], [1, 2, 3], data=2, model=4)
    for alive, failed in ((4, []), (3, [1]), (1, [0])):
        pa, pb = tr.FailurePolicy(min_hosts=2), jr.FailurePolicy(min_hosts=2)
        assert pa.decide(alive, failed).value == pb.decide(alive,
                                                           failed).value
        assert pa.restarts == pb.restarts
    hb = (tr.HeartbeatMonitor(3, timeout_s=5.0),
          jr.HeartbeatMonitor(3, timeout_s=5.0))
    for m in hb:
        m.beat(0, 10.0)
        m.beat(2, 1.0)
    assert hb[0].failed_hosts(now=12.0) == hb[1].failed_hosts(now=12.0)
    # the monitor through jitter: targets, speeds and slow hosts
    mons = (tr.StragglerMonitor(), jr.StragglerMonitor())
    rng = np.random.default_rng(0)
    for i in range(30):
        t = float(rng.uniform(0.9, 1.6 if i > 12 else 1.0))
        outs = []
        for m in mons:
            m.record_step(t)
            for h in range(3):
                m.record_host_step(h, t * (3.0 if h == 2 else 1.0))
            outs.append((m.adjusted_target(), m.jitter,
                         m.host_speeds(range(3)).tolist(), m.slow_hosts()))
        assert outs[0] == outs[1]
    # the run_with_recovery verdicts over cumulative losses
    for rt in (tr, jr):
        calls = {"n": 0}

        def step(s, calls=calls, rt=rt):
            if s == 2 and calls["n"] == 0:
                calls["n"] += 1
                raise rt.TrainingFailure("lost 0", failed_hosts=[0])
        assert rt.run_with_recovery(
            step, start_step=0, total_steps=4,
            policy=rt.FailurePolicy(min_hosts=3),
            on_restore=lambda a, f: 2, num_hosts=4,
            logger=lambda *_: None) == 4


def test_loop_setup_copies_match_reference():
    from types import SimpleNamespace as NS
    for kw, n_dev, model in ((dict(fail_at="3:1", hosts=2), 4, 2),
                             (dict(straggle=["1:2.0"]), 4, 2),
                             (dict(fail_at="5", hosts=4,
                                   max_restarts=2), 8, 4), ({}, 1, 1)):
        a = ttrain._ft_setup(NS(**kw), n_dev, model)
        b = jtrain._ft_setup(NS(**kw), n_dev, model)
        assert (a[0].num_hosts, a[0].devices_per_host, a[1].min_hosts,
                a[1].max_restarts, a[3].fail_step, a[3].fail_hosts,
                a[4].factors) == \
            (b[0].num_hosts, b[0].devices_per_host, b[1].min_hosts,
             b[1].max_restarts, b[3].fail_step, b[3].fail_hosts,
             b[4].factors)
    with pytest.raises(ValueError, match="out of range"):
        ttrain._ft_setup(NS(fail_at="1:2", hosts=2), 4, 2)
    for args in ((4, 1, 2), (4, 2, 2), (2, 2, 2), (6, 3, 2), (4, 4, 1)):
        assert ttrain._effective_accum(*args) == \
            jtrain._effective_accum(*args)


def _losses(out: str) -> list[float]:
    return [float(line.split()[4]) for line in out.splitlines()
            if line.startswith("[train] step")]


SEQ, BATCH, STEPS = 1024, 4, 7


@pytest.mark.parametrize("dispatch", [True, False],
                         ids=["dispatch", "plain"])
def test_lost_host_shrinks_as_the_reference(dispatch, capfd, tmp_path):
    seed_checkpoint(main, tmp_path / "port", SEQ, BATCH)
    capfd.readouterr()
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ref = reference_train(tmp_path / "ref", 4, mesh="2x2", seq_len=SEQ,
                          batch=BATCH, steps=STEPS, ckpt_every=1,
                          dispatch=dispatch, hosts=2, fail_at="3:1")
    main(SMOKE + ["--seq-len", str(SEQ), "--batch", str(BATCH), "--steps",
                  str(STEPS), "--mesh", "2x2", "--dist-backend", "gloo",
                  "--checkpoint-dir", str(tmp_path / "port"), "--resume",
                  "--hosts", "2", "--fail-at", "3:1", "--ckpt-every", "1"]
         + (["--dispatch"] if dispatch else []))
    out = capfd.readouterr().out
    assert "[recovery] shrink -> mesh 1x2 on 2 surviving devices " \
        "(accum 2)" in out
    assert "restored step 3 after elastic_shrink (mesh 1x2, accum 2)" in out
    assert (ref["mesh"], ref["accum"], ref["dead_hosts"],
            ref["recoveries"]) == ([1, 2], 2, [1], 1)
    assert len(ref["losses"]) == STEPS - 1
    np.testing.assert_allclose(_losses(out), ref["losses"], rtol=1e-4)


@pytest.mark.parametrize("prefetch", [False, True])
def test_restart_replays_to_the_uninterrupted_losses(prefetch, capfd,
                                                     tmp_path):
    argv = SMOKE + ["--seq-len", "512", "--batch", "2", "--steps", "5",
                    "--mesh", "1x2", "--dist-backend", "gloo",
                    "--ckpt-every", "2"] + (["--prefetch"] if prefetch
                                            else [])
    main(argv + ["--checkpoint-dir", str(tmp_path / "a")])
    whole = _losses(capfd.readouterr().out)
    main(argv + ["--checkpoint-dir", str(tmp_path / "b"), "--fail-at", "4"])
    out = capfd.readouterr().out
    assert "action=restart" in out and "restored step 3 after restart" in out
    got = _losses(out)
    # steps 0-3, then step 3 again from its checkpoint, then step 4
    assert len(got) == 6
    np.testing.assert_allclose(got, whole[:4] + whole[3:], rtol=1e-6)


def test_ranks_agree_under_stragglers(tmp_path):
    """``--mesh 2x2 --dispatch --straggle 1:2.0`` for 12 steps (the
    monitor reads jitter from step 10): every rank's targets, degrees
    and placements (group speeds included) are rank 0's."""
    import _torch_elastic_ranks as ranks
    from repro_torch.launch.ranks import spawn_ranks

    argv = SMOKE + ["--seq-len", "512", "--batch", "4", "--steps", "12",
                    "--mesh", "2x2", "--dist-backend", "gloo", "--dispatch",
                    "--hosts", "2", "--straggle", "1:2.0"]
    spawn_ranks(ranks.loop_rank, 4, args=(4, str(tmp_path / "store"),
                                          str(tmp_path), argv), timeout=240)
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(4)]
    for r in range(1, 4):
        for k in ("degrees", "targets", "dispatch"):
            assert got[r][k] == got[0][k], (r, k)
        np.testing.assert_allclose(got[r]["losses"], got[0]["losses"],
                                   rtol=1e-6)
    speeds = [d.get("group_speeds") for d in got[0]["dispatch"]]
    assert speeds[0] is None and any(s is not None for s in speeds[1:])
    assert len(got[0]["losses"]) == 12 and got[0]["recoveries"] == 0
