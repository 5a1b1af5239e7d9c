"""Serving resilience of the port against the JAX package: chaos
quarantine, snapshot / kill / drain-restore and ``attn_shards``.

The engine cases of the reference's ``tests/test_resilience.py`` run on
the port's CPU engine in both KV layouts: NaN logits at decode and at
prefill, stuck slots, delay counting, ``parse_chaos``, kill -> restore
with the same tokens (temperature sampling included), drain -> restore,
and a refused geometry mismatch.  Beside them, on the same prompts and
the reference's own parameters (converted), greedy: the same chaos specs
give the JAX engine (Pallas in interpret mode) and the port's the same
statuses, reasons and tokens; a snapshot's metadata (scheduler, queue,
slots, pool refcounts and free list, prefix trie in LRU order, request
cursors) equals the reference's at the same kill step; the dense engine
at ``attn_shards`` 2 and 4 gives the reference's tokens; and the CLI
takes the chaos and snapshot flags.
"""

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import models as jm
from repro.serve import ChaosInjector as JChaos
from repro.serve import EngineKilled as JKilled
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.serve import build_parser, serve
from repro_torch.models import params_from_numpy
from repro_torch.serve import (ChaosInjector, EngineKilled, ServeEngine,
                               parse_chaos)

ARCH = "starcoder2_3b"
LAYOUTS = ("paged", "dense")
GEOM = dict(num_slots=2, max_len=48, prefill_chunk=8)
GEN = 5
# chaos cases: (name, injector kwargs, extra engine kwargs)
CHAOS = {"nan_decode": (dict(nan_logits={1: 6}), {}),
         "nan_prefill": (dict(nan_logits={0: 0}), {}),
         "stuck": (dict(stuck={2: 4}), dict(stall_patience=4))}
# metrics that are wall-clock times, not state
TIMED = ("prefill_s", "decode_s", "chaos_delay_s", "latency_s", "waited_s")


def _prompts(seed=3, n=4, length=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, length).astype(np.int32)
            for _ in range(n)]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduce_for_smoke(tconfigs.get_config(ARCH))
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def _port(models, layout, chaos=None, **kw):
    _, tcfg, _, tp = models
    return ServeEngine(tcfg, tp, device="cpu", kv_layout=layout, chaos=chaos,
                       **{**GEOM, **kw})


def _jax(models, layout, chaos=None, **kw):
    jcfg, _, jp, _ = models
    return JaxEngine(jcfg, params=jp, kv_layout=layout, chaos=chaos,
                     **{**GEOM, **kw})


def _drive(eng, prompts=PROMPTS, **run_kw):
    for p in prompts:
        eng.submit(p, max_new=GEN)
    return eng, eng.run(max_steps=300, **run_kw)


def _outcome(res):
    return {r: (e["status"], e.get("reason"), [int(t) for t in e["tokens"]])
            for r, e in res.items()}


@pytest.fixture(scope="module")
def runs(models):
    """{(layout, case): (port engine, port results, JAX results)} for the
    uninjected baseline and every chaos case."""
    out = {}
    for layout in LAYOUTS:
        for case in ("baseline", *CHAOS):
            ch, kw = CHAOS.get(case, ({}, {}))
            teng, tres = _drive(_port(models, layout,
                                      ChaosInjector(**ch) if ch else None,
                                      **kw))
            _, jres = _drive(_jax(models, layout,
                                  JChaos(**ch) if ch else None, **kw))
            out[layout, case] = (teng, tres, jres)
    return out


def _assert_healthy_same(res, baseline, poisoned):
    for r in baseline:
        if r in poisoned:
            continue
        assert res[r]["status"] == "ok", (r, res[r])
        assert np.array_equal(res[r]["tokens"], baseline[r]["tokens"]), \
            f"healthy request {r} diverged from the uninjected run"


# ===================================================================== #
# chaos: fault quarantine (the reference's engine cases)
# ===================================================================== #
@pytest.mark.parametrize("layout", LAYOUTS)
def test_nan_decode_aborts_only_poisoned(runs, layout):
    base = runs[layout, "baseline"][1]
    eng, res, _ = runs[layout, "nan_decode"]
    assert all(e["status"] == "ok" for e in base.values())
    assert res[1]["status"] == "aborted"
    assert "non-finite decode" in res[1]["reason"]
    _assert_healthy_same(res, base, {1})
    assert eng.stats["aborted_by_reason"] == {"nan_logits": 1}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_nan_prefill_aborts_before_prefix_insert(runs, layout):
    """Poisoned from step 0: the fault fires on the request's final
    prefill chunk, and none of its blocks reaches the prefix cache."""
    base = runs[layout, "baseline"][1]
    eng, res, _ = runs[layout, "nan_prefill"]
    assert res[0]["status"] == "aborted"
    assert "prefill" in res[0]["reason"]
    assert len(res[0]["tokens"]) == 0
    _assert_healthy_same(res, base, {0})
    if eng.prefix is not None:
        # every block the trie holds is live, and they are the healthy
        # prompts' full blocks only
        for bid in eng.prefix._lru:
            assert eng.pool.refcount(bid) >= 1
        assert len(eng.prefix) == 3 * (len(PROMPTS[0]) // eng.block_size)


def test_nan_served_silently_without_watchdog(models):
    """The pre-quarantine engine: with the watchdog off, the poisoned
    request ends "ok" with NaN-sampled tokens and no signal."""
    _, res = _drive(_port(models, "paged", ChaosInjector(nan_logits={1: 6}),
                          watchdog=False))
    assert res[1]["status"] == "ok"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stuck_slot_watchdog_aborts(runs, layout):
    base = runs[layout, "baseline"][1]
    eng, res, _ = runs[layout, "stuck"]
    assert res[2]["status"] == "aborted"
    assert "no scheduler progress" in res[2]["reason"]
    _assert_healthy_same(res, base, {2})
    assert eng.stats["aborted_by_reason"] == {"stall": 1}
    assert eng.stats["steps"] < 100


def test_chaos_delay_is_counted(models):
    eng, res = _drive(_port(models, "paged",
                            ChaosInjector(delays={3: 0.05})))
    assert all(res[r]["status"] == "ok" for r in res)
    assert eng.stats["chaos_delay_s"] == pytest.approx(0.05)


def test_parse_chaos_specs():
    ch = parse_chaos(["1:6", "3:2"], ["2:8"], ["5:0.25"], kill_at=9)
    assert ch.nan_logits == {1: 6, 3: 2}
    assert ch.stuck == {2: 8}
    assert ch.delays == {5: 0.25}
    assert ch.kill_at == 9
    assert parse_chaos([], [], [], kill_at=-1) is None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["baseline", *CHAOS])
def test_chaos_matches_jax_engine(runs, layout, case):
    """The same specs on the JAX engine: the same statuses, reasons and
    greedy tokens, request by request."""
    _, tres, jres = runs[layout, case]
    assert _outcome(tres) == _outcome(jres)


def test_decode_poison_keeps_healthy_logits_bit_for_bit(models):
    """The NaN lands after the forward: the healthy rows' logits are the
    unpoisoned step's, bit for bit."""
    import torch

    eng = _port(models, "dense")
    B = eng.num_slots
    args = (torch.tensor([5, 9]), torch.tensor([3, 4], dtype=torch.int32),
            torch.ones(B, dtype=torch.bool))
    clean = eng._decode(*args, torch.zeros(B, dtype=torch.bool))
    hit = eng._decode(*args, torch.tensor([False, True]))
    assert torch.equal(hit[0], clean[0])
    assert torch.isnan(hit[1]).all()


# ===================================================================== #
# snapshot / restore
# ===================================================================== #
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kill_restore_bitwise_parity(models, tmp_path, layout):
    """A mid-decode kill, then a restore into a fresh engine: every
    request finishes with the uninterrupted run's tokens, temperature
    sampling included (the sampling cursors restore)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, 24).astype(np.int32) for _ in range(4)]

    def submit_all(eng):
        for p in prompts:
            eng.submit(p, max_new=GEN, temperature=1.0, top_k=8)

    ref = _port(models, layout)
    submit_all(ref)
    expected = ref.run()

    snap = str(tmp_path / f"snap_{layout}")
    killed = _port(models, layout, ChaosInjector(kill_at=7))
    submit_all(killed)
    with pytest.raises(EngineKilled):
        killed.run(snapshot_every=3, snapshot_dir=snap)

    eng = _port(models, layout)
    eng.warmup()
    assert eng.restore_snapshot(snap) == 6        # latest multiple of 3
    res = eng.run()
    assert set(res) == set(expected), "request lost across restore"
    for r in expected:
        assert res[r]["status"] == "ok"
        assert np.array_equal(res[r]["tokens"], expected[r]["tokens"]), r


@pytest.mark.parametrize("layout", LAYOUTS)
def test_drain_restore_finishes_inflight(models, tmp_path, layout):
    _, expected = _drive(_port(models, layout), PROMPTS[:3])
    snap = str(tmp_path / "drain")
    d, _ = _drive(_port(models, layout), PROMPTS[:3], drain_at=5,
                  snapshot_dir=snap)
    assert d.sched.has_work                   # drained mid-flight
    eng = _port(models, layout)
    eng.restore_snapshot(snap)
    res = eng.run()
    for r in expected:
        assert np.array_equal(res[r]["tokens"], expected[r]["tokens"]), r


def test_restore_rejects_geometry_mismatch(models, tmp_path):
    _port(models, "paged").snapshot(str(tmp_path))
    other = _port(models, "paged", num_slots=4)
    with pytest.raises(ValueError, match="geometry"):
        other.restore_snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="snapshot_dir"):
        _port(models, "paged").run(snapshot_every=2)


def _strip(x):
    """A snapshot's metadata without its wall-clock fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMED}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


@pytest.mark.parametrize("layout", LAYOUTS)
def test_snapshot_metadata_matches_reference(models, tmp_path, layout):
    """Both engines killed at step 7 after snapshots every 3 steps: the
    snapshots' scheduler, queue, slots (generated tokens = the sampling
    cursors), pool refcounts and free list and prefix trie in LRU order
    are the same; the port's stats are the reference's on every key they
    share, and its KV leaves the reference's."""
    metas = []
    for kind, make, chaos, killed in (("jax", _jax, JChaos, JKilled),
                                      ("port", _port, ChaosInjector,
                                       EngineKilled)):
        snap = str(tmp_path / kind)
        eng = make(models, layout, chaos(kill_at=7))
        for p in PROMPTS:
            eng.submit(p, max_new=GEN)
        with pytest.raises(killed):
            eng.run(snapshot_every=3, snapshot_dir=snap)
        mgr = CheckpointManager(snap)
        metas.append(mgr.restore(6))
    (_, jtree, jman), (_, ttree, tman) = metas
    jx, tx = _strip(jman["extra"]), _strip(tman["extra"])
    for key in ("geometry", "scheduler", "pool", "prefix"):
        assert tx[key] == jx[key], key
    assert tx["engine"]["next_rid"] == jx["engine"]["next_rid"]
    shared = set(tx["engine"]["stats"]) & set(jx["engine"]["stats"])
    assert {"steps", "decode_tokens", "cow_copies"} <= shared
    for k in shared:
        assert tx["engine"]["stats"][k] == jx["engine"]["stats"][k], k
    assert tx["scheduler"]["slots"], "the kill landed mid-flight"
    for k in jtree["cache"]:
        np.testing.assert_allclose(ttree["cache"][k].numpy(),
                                   jtree["cache"][k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
    for key in ("prompts", "fin_tokens"):
        assert sorted(ttree.get(key, {})) == sorted(jtree.get(key, {}))
        for r in jtree.get(key, {}):
            assert np.array_equal(ttree[key][r].numpy(),
                                  jtree[key][r].numpy())


# ===================================================================== #
# attn_shards
# ===================================================================== #
@pytest.mark.parametrize("shards", [2, 4])
def test_attn_shards_tokens_match_reference(models, shards):
    """``attn_shards`` picks the dense layout under "auto" (paged is
    refused) and its tokens are the reference's and the unsharded
    engine's."""
    toks = []
    for make in (_jax, _port):
        eng, res = _drive(make(models, "auto", attn_shards=shards))
        assert eng.layout == "dense"
        toks.append(_outcome(res))
    _, base = _drive(_port(models, "dense"))
    assert toks[1] == toks[0] == _outcome(base)
    with pytest.raises(ValueError, match="dense-layout"):
        _port(models, "paged", attn_shards=shards)


# ===================================================================== #
# the CLI
# ===================================================================== #
def test_serve_cli_chaos_kill_restore(tmp_path):
    """Poisoned, stuck and delayed requests and a kill at step 9 with
    snapshots every 3 steps, restored in-process: every request ends,
    exactly the poisoned and stuck ones aborted, every healthy one with
    the uninjected run's tokens; then an orderly drain."""
    base = ["--smoke", "--device", "cpu", "--requests", "6", "--slots", "3",
            "--prompt-len", "48", "--gen", "8", "--stall-patience", "4"]
    clean = serve(build_parser().parse_args(base))
    out = serve(build_parser().parse_args(base + [
        "--chaos-nan", "1:6", "--chaos-stuck", "2:4", "--chaos-delay",
        "3:0.01", "--kill-at", "9", "--snapshot-every", "3",
        "--snapshot-dir", str(tmp_path / "snap")]))
    assert out["restored_from"] == 9
    res = out["results"]
    assert set(res) == set(range(6))
    assert {r for r, e in res.items() if e["status"] != "ok"} == {1, 2}
    assert "non-finite" in res[1]["reason"]
    assert "no scheduler progress" in res[2]["reason"]
    for r in (0, 3, 4, 5):
        assert np.array_equal(res[r]["tokens"], clean["tokens"][r]), r
    drained = serve(build_parser().parse_args(base + [
        "--kv-layout", "dense", "--attn-shards", "2", "--drain-at", "4",
        "--snapshot-dir", str(tmp_path / "drain")]))
    assert drained["restored_from"] == 4
    assert drained["kv_layout"] == "dense"
    assert set(drained["tokens"]) == set(range(6))
    for r in range(6):
        assert np.array_equal(drained["tokens"][r], clean["tokens"][r]), r


def test_serve_cli_takes_every_reference_flag():
    """Every option of the reference's ``launch/serve.py`` parses in the
    port's CLI (the port adds ``--device``)."""
    import os
    import re

    src = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                       "launch", "serve.py")
    with open(src) as f:
        flags = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                               f.read()))
    assert {"--attn-shards", "--chaos-nan", "--kill-at",
            "--snapshot-dir"} <= flags
    ours = {o for a in build_parser()._actions for o in a.option_strings}
    assert flags <= ours, sorted(flags - ours)
