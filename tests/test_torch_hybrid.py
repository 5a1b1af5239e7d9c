"""The port's recurrent families (jamba_v0_1_52b hybrid, xlstm_350m SSM)
against the JAX package, at smoke size, float32, on the same numpy
inputs and the reference's own parameters, converted.

* The configs: fields, periods, block kinds and parameter counts exact.
* Loss (1e-5 relative) and every gradient leaf (1e-4 of its largest
  entry, as tests/test_torch_train.py holds the dense stacks) at the
  config's own MoE capacity (1.25: the smoke jamba's MoE clips, as the
  reference's does).
* Decode step by step against the forward's logits at a drop-free
  capacity: < 1e-4, the bound of the reference's own decode-vs-forward
  test.
* The serving engine (dense layout, replay prefill, greedy): the JAX
  engine's statuses, tokens and replay-step count; ``paged`` refused,
  ``auto`` resolving to dense; a reused slot replays from a zeroed
  state (the reference carries the previous request's, ROADMAP F3); a
  snapshot holds the reference's cache leaves in its leaf order, and a
  killed engine restores to the uninterrupted run's tokens.
* ``effective_strategy`` equals the reference's for every family and
  planner.

The 1x2 CP step is in tests/test_torch_hybrid_cp.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch.steps import effective_strategy as j_effective
from repro.models import transformer as jtm
from repro.models.context import make_local_context as jctx
from repro.planner import available_planners as j_planners
from repro.serve import ChaosInjector as JChaos
from repro.serve import EngineKilled as JKilled
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tcfgs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.steps import effective_strategy
from repro_torch.models import make_local_context, params_from_numpy
from repro_torch.models import transformer as tm
from repro_torch.planner import available_planners
from repro_torch.serve import ChaosInjector, EngineKilled, ServeEngine

ARCHS = ("jamba_v0_1_52b", "xlstm_350m")
LOSS_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these shapes are tiny, and with the host's
    cores shared by parallel test workers, more threads only wait on
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree).astype(np.float32)}


def _close(got, want, rel, what=""):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=rel * scale, rtol=0, err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(JAX config, port config, JAX params, port params) of one smoke
    arch."""
    arch = request.param
    jc = jcfgs.reduce_for_smoke(jcfgs.get_config(arch))
    tc = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    jp = jtm.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(_np_tree(jp), device="cpu")


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if smoke:
        jc, tc = jcfgs.reduce_for_smoke(jc), tcfgs.reduce_for_smoke(tc)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tm.period_length(tc) == jtm.period_length(jc)
    assert tm.block_kinds(tc) == jtm.block_kinds(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tm.supports_cached_prefill(tc) is False
    assert tm.supports_paged_cache(tc) is False


def test_params_tree_matches_reference(models):
    jc, tc, jp, _ = models
    mine = tm.init_params(tc, seed=0, device="cpu")
    want = {k: v.shape for k, v in _flat(_np_tree(jp)).items()}
    assert {k: v.shape for k, v in _flat(mine).items()} == want


# --------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------- #
def _batch(vocab, seed=2, B=2, T=256):
    rng = np.random.default_rng(seed)
    lens = (90, 40, 126)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    doc = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]) \
        .astype(np.int32)
    tokens = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, np.cumsum(lens) - 1] = -1
    return (tokens, labels, np.tile(doc, (B, 1)), np.tile(pos, (B, 1)))


def test_loss_and_gradients_match_jax(models):
    jc, tc, jp, tp = models
    tokens, labels, doc, pos = _batch(jc.vocab_size)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jf = jax.jit(jax.value_and_grad(
        lambda p: jtm.loss_fn(p, jc, jctx(jnp.asarray(doc),
                                          jnp.asarray(pos)), jb,
                              remat=False), has_aux=True))
    (jl, jm), jg = jf(jp)
    names = sorted(_flat(tp))
    flat = {n: v for n, v in zip(names, _leaves(tp))}
    for v in flat.values():
        v.requires_grad_(True)
    ctx = make_local_context(torch.from_numpy(doc), torch.from_numpy(pos))
    loss, metrics = tm.loss_fn(tp, tc, ctx,
                               {"tokens": torch.from_numpy(tokens).long(),
                                "labels": torch.from_numpy(labels).long()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["aux"].item(), float(jm["aux"]),
                               rtol=LOSS_TOL, atol=1e-7)
    jgf = _flat(_np_tree(jg))
    for n, g in zip(flat, grads):
        _close(g.numpy(), jgf[n], GRAD_TOL, n)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# --------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------- #
def test_decode_matches_forward_logits(models):
    """Drop-free (the forward routes B*T tokens at once, decode B), so the
    two paths route alike."""
    _, tc, _, tp = models
    B, T = 2, 16
    tc = dataclasses.replace(tc, capacity_factor=float(B * T))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tc.vocab_size, (B, T)).astype(np.int64)
    doc = np.zeros((B, T), np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    ctx = make_local_context(torch.from_numpy(doc), torch.from_numpy(pos))
    with torch.no_grad():
        ref, _ = tm.forward(tp, tc, ctx,
                            {"tokens": torch.from_numpy(tokens)},
                            remat=False)
        cache = tm.init_cache(tc, B, T, device="cpu")
        worst = 0.0
        for t in range(T):
            lg, _ = tm.decode_step(tp, tc, cache,
                                   {"tokens": torch.from_numpy(tokens[:, t])},
                                   torch.full((B,), t, dtype=torch.int32))
            worst = max(worst, (lg - ref[:, t]).abs().max().item())
    assert worst < DECODE_TOL, worst


def test_decode_writes_only_masked_rows(models):
    _, tc, _, tp = models
    cache = tm.init_cache(tc, 3, 8, device="cpu")
    mask = torch.tensor([False, True, False])
    with torch.no_grad():
        tm.decode_step(tp, tc, cache, {"tokens": torch.tensor([5, 6, 7])},
                       torch.zeros(3, dtype=torch.int32), write_mask=mask)
    for sub in cache.values():
        for name, leaf in sub.items():
            assert not leaf[:, [0, 2]].any(), name
            if name != "v" or tc.family == "ssm":
                assert leaf[:, 1].any(), name


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
GEOM = dict(num_slots=4, max_len=40, prefill_chunk=8)
GEN = 5


def _prompts(seed=3, lens=(9, 14, 6, 11)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _outcome(res):
    return {r: (e["status"], [int(t) for t in e["tokens"]])
            for r, e in res.items()}


def _port(models, chaos=None, **kw):
    _, tc, _, tp = models
    return ServeEngine(tc, tp, device="cpu", chaos=chaos, **{**GEOM, **kw})


def _jax(models, chaos=None, **kw):
    jc, _, jp, _ = models
    return JEngine(jc, params=jp, chaos=chaos, **{**GEOM, **kw})


def test_engine_matches_jax_engine(models):
    outs, steps = [], []
    for make in (_jax, _port):
        eng = make(models)
        eng.warmup()
        for p in _prompts():
            eng.submit(p, max_new=GEN)
        outs.append(_outcome(eng.run()))
        steps.append((eng.layout, eng.stats["prefill_decode_steps"],
                      eng.stats["prefill_steps"], eng.stats["decode_steps"]))
    assert outs[0] == outs[1]
    assert steps[0] == steps[1] == ("dense", 40, 0, steps[0][3])
    assert all(s == "ok" for s, _ in outs[1].values())


def test_paged_layout_is_refused(models):
    _, tc, _, tp = models
    with pytest.raises(ValueError, match="attention-only mixers"):
        ServeEngine(tc, tp, device="cpu", kv_layout="paged", max_len=32)
    with pytest.raises(ValueError, match="attention-only mixers"):
        tm.init_paged_cache(tc, 4, 16, device="cpu")
    with pytest.raises(ValueError, match="attention-only mixers"):
        tm.prefill_forward(tp, tc, tm.init_cache(tc, 1, 16, device="cpu"),
                           {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                           torch.zeros((1, 4), dtype=torch.int32),
                           torch.ones((1, 4), dtype=torch.bool))
    assert ServeEngine(tc, tp, device="cpu", max_len=32).layout == "dense"


def _states(eng):
    return [leaf.clone() for sub in eng.cache.values()
            for name, leaf in sorted(sub.items()) if name not in ("k", "v")]


def test_reused_slot_replays_from_a_zeroed_state(models):
    """One slot, two requests: the second's tokens, and its recurrent
    states after the run, are those it gets alone in a fresh engine.  The
    reference's replay starts from the slot's previous request's final
    recurrent state (F3); in the smoke jamba, whose slowest Mamba decays
    keep it, that changes the request's tokens."""
    _, tc, _, _ = models
    p1, p2 = _prompts(seed=7, lens=(12, 9))
    eng = _port(models, num_slots=1)
    eng.submit(p2, max_new=GEN)
    alone = _outcome(eng.run())[0]
    state = _states(eng)
    eng = _port(models, num_slots=1)
    eng.submit(p1, max_new=GEN)
    eng.submit(p2, max_new=GEN)
    assert _outcome(eng.run())[1] == alone
    for a, b in zip(state, _states(eng)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    if tc.family == "hybrid":
        # one reference engine, twice: p2 fresh, then p1 and p2 again,
        # each replayed over the slot's previous state
        jeng = _jax(models, num_slots=1)
        jeng.submit(p2, max_new=GEN)
        jalone = _outcome(jeng.run())[0]
        jeng.submit(p1, max_new=GEN)
        jeng.submit(p2, max_new=GEN)
        assert jalone == alone
        assert _outcome(jeng.run())[2] != alone


def test_snapshot_holds_reference_leaves_and_restores(models, tmp_path):
    """Both engines killed at step 5 after snapshots every 2 steps: the
    port's snapshot holds the reference's cache leaves, in its leaf order
    (the recurrent conv/ssm, C/N and c states among them), at 1e-5; a
    fresh port engine restored from it finishes with the uninterrupted
    run's tokens."""
    jc, tc, _, _ = models
    trees = []
    for kind, make, chaos, killed in (("jax", _jax, JChaos, JKilled),
                                      ("port", _port, ChaosInjector,
                                       EngineKilled)):
        snap = str(tmp_path / kind)
        eng = make(models, chaos(kill_at=5))
        for p in _prompts():
            eng.submit(p, max_new=2 * GEN)
        with pytest.raises(killed):
            eng.run(snapshot_every=2, snapshot_dir=snap)
        trees.append(CheckpointManager(snap).restore(4)[1])
    jtree, ttree = trees
    jleaves = jax.tree.leaves(jtm.init_cache(jc, GEOM["num_slots"],
                                             GEOM["max_len"]))
    assert len(ttree["cache"]) == len(jtree["cache"]) == len(jleaves)
    for k, shape in zip(sorted(jtree["cache"]), (x.shape for x in jleaves)):
        assert tuple(ttree["cache"][k].shape) == shape, k
        np.testing.assert_allclose(ttree["cache"][k].float().numpy(),
                                   jtree["cache"][k].float().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    ref = _port(models)
    for p in _prompts():
        ref.submit(p, max_new=2 * GEN)
    expected = _outcome(ref.run())
    eng = _port(models)
    eng.warmup()
    assert eng.restore_snapshot(str(tmp_path / "port")) == 4
    assert _outcome(eng.run()) == expected


# --------------------------------------------------------------------- #
# training strategy
# --------------------------------------------------------------------- #
def test_effective_strategy_matches_reference():
    assert set(available_planners()) <= set(j_planners())
    for arch in ("starcoder2_3b", "olmoe_1b_7b", *ARCHS):
        tc, jc = tcfgs.get_config(arch), jcfgs.get_config(arch)
        for name in available_planners():
            assert effective_strategy(tc, name) == j_effective(jc, name), \
                (arch, name)
    assert effective_strategy(tcfgs.get_config("xlstm_350m"),
                              "flashcp") == "contiguous"
    with pytest.raises(KeyError):
        effective_strategy(tcfgs.get_config("xlstm_350m"), "bogus")
