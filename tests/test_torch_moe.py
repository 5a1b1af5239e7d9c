"""The port's MoE family against the JAX package, on identical inputs:
the same numpy arrays and the reference's own parameters, converted;
float32 throughout.

* ``moe_apply`` (output, aux, gradients) at cf 1.25, where the capacity
  clips tokens, and at cf 8.0 (drop-free): 1e-5 of each array's largest
  entry — the same f32 products, scatter-adds in another order.
* The configs: fields, block kinds, period and parameter counts exact.
* A smoke olmoe's loss (1e-5 relative) and gradients (1e-4 of each
  leaf's largest entry, as tests/test_torch_train.py holds the dense
  stacks), and its decode logits against its forward at < 1e-4 (the
  port's gate of the reference's decode-vs-forward test).
* Drop-free prefill against replay through the decode path (1e-4, as the
  reference's own test).
* The expert-parallel island at N = 2 and 4 (gloo ranks) against the
  reference's ``make_cp_context(...).extras["ep_dispatch"]`` on simulated
  host devices, in a subprocess, at cf 1.25 with clipped tokens: 1e-5.
* A 2x2 ZeRO-3 step (EP over ``model``) against the JAX step, at a
  drop-free capacity (the capacity is per rank, so a clipping run is not
  the one-device run's): the bounds of tests/test_torch_train.py.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_moe_ranks as mranks
import repro.configs as jcfgs
from repro.compat import set_mesh
from repro.configs.base import RunConfig as JRun, ShapeConfig
from repro.data.pipeline import PipelineConfig as JPipe, make_batch as jbatch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_train_step as jbuild
from repro.models import init_params as jinit
from repro.models import moe as jmoe
from repro.models import transformer as jtm
from repro.models.context import make_local_context as jctx
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tcfgs
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.launch.steps import batch_to_device
from repro_torch.models import make_local_context, params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tm
from repro_torch.runtime import sharding

jsharding = importlib.import_module("repro.runtime.sharding")

ARCH = "olmoe_1b_7b"
TOL = 1e-5
JOIN_TIMEOUT = 240
HERE = os.path.dirname(os.path.abspath(__file__))


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
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=rel * scale, rtol=0, err_msg=what)


def _models(seed=0, **cfg_kw):
    jc = dataclasses.replace(jcfgs.reduce_for_smoke(jcfgs.get_config(ARCH)),
                             **cfg_kw)
    tc = dataclasses.replace(tcfgs.reduce_for_smoke(tcfgs.get_config(ARCH)),
                             **cfg_kw)
    jp = jinit(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(_np_tree(jp), device="cpu")


# --------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_apply_matches_jax(cf):
    B, T, d, f, E, K = 2, 32, 64, 128, 8, 2
    rng = np.random.default_rng(0)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), d, f, E, "glu")
    # a shared offset skews the routing towards a few experts
    x = (rng.standard_normal((B, T, d))
         + 2.0 * rng.standard_normal(d)).astype(np.float32)
    w = rng.standard_normal((B, T, d)).astype(np.float32)

    def jf(p, x):
        o, aux = jmoe.moe_apply(p, x, None, top_k=K, capacity_factor=cf,
                                kind="glu")
        return jnp.sum(o * w) + aux, (o, aux)

    (_, (jo, ja)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    o, aux = tmoe.moe_apply(tp, tx, None, top_k=K, capacity_factor=cf,
                            kind="glu")
    (torch.sum(o * torch.from_numpy(w)) + aux).backward()
    _close(o.detach(), jo, TOL, "out")
    np.testing.assert_allclose(aux.item(), float(ja), rtol=TOL)
    _close(tx.grad, jgx, TOL, "dx")
    for k in tp:
        _close(tp[k].grad, jgp[k], TOL, f"d{k}")
    # which (token, choice) pairs the capacity drops
    cap = tmoe.capacity(B * T, E, K, cf)
    _, topi = torch.topk(torch.softmax(tx.detach() @ tp["router"].detach(),
                                       -1), K)
    per_expert = torch.bincount(topi.reshape(-1), minlength=E)
    dropped = int(torch.clamp(per_expert - cap, min=0).sum())
    assert (dropped > 0) == (cf == 1.25), (cap, per_expert.tolist())


def test_dispatch_keeps_lower_tokens_first():
    """The stable sort: within an expert the lower token index keeps its
    slot, as the reference's ``argsort(stable=True)``."""
    n, d, E, K, cap = 12, 4, 2, 1, 3
    x = torch.arange(n * d, dtype=torch.float32).reshape(n, d)
    topi = torch.zeros((n, K), dtype=torch.int32)
    buf, slot, tok_s, _, keep = tmoe.dispatch_local(
        x, topi, torch.ones((n, K)), E, cap)
    assert tok_s[keep].tolist() == [0, 1, 2]
    assert torch.equal(buf[0], x[:3]) and not buf[1].any()
    jb, jslot, jtok, _, jkeep = jmoe.dispatch_local(
        jnp.asarray(x.numpy()), jnp.asarray(topi.numpy()),
        jnp.ones((n, K)), E, cap)
    assert np.array_equal(np.asarray(jb), buf.numpy())
    assert np.array_equal(np.asarray(jslot), slot.numpy())
    assert np.array_equal(np.asarray(jkeep), keep.numpy())


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "dbrx_132b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_moe_configs_match_reference(arch, smoke):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if smoke:
        jc, tc = jcfgs.reduce_for_smoke(jc), tcfgs.reduce_for_smoke(tc)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tm.block_kinds(tc) == jtm.block_kinds(jc)
    assert tm.period_length(tc) == jtm.period_length(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    # every second layer MoE: a period of 2, the counts still agree
    jc2, tc2 = (dataclasses.replace(c, moe_every=2) for c in (jc, tc))
    assert tm.block_kinds(tc2) == jtm.block_kinds(jc2) \
        == [("attn", "dense"), ("attn", "moe")]
    assert tc2.param_count() == jc2.param_count()
    assert tc2.active_param_count() == jc2.active_param_count()


def test_moe_params_tree_matches_reference():
    _, tc, jp, _ = _models()
    got = _flat(tm.init_params(tc, seed=0, device="cpu"))
    want = _flat(_np_tree(jp))
    assert {k: v.shape for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}
    assert "layers.sub_0.moe.router" in got and "layers.sub_0.mlp.wi" \
        not in got


class DuckMesh:
    """What the reference's sharding rules read of a mesh."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2), (1, 4), (2, 4),
                                  (1, 128)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_expert_layout_matches_reference(mesh):
    """Full-width olmoe: the expert leaves by the reference's
    ``_expert_spec`` (E over ``model``; at 1x128, E = 64 does not divide
    and stays whole), every other leaf by ``_leaf_spec``."""
    cfg = jcfgs.get_config(ARCH)
    tree = jax.eval_shape(lambda k: jinit(k, cfg), jax.random.PRNGKey(0))
    shapes = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    axes = dict(zip(("data", "model"), mesh))
    got = sharding.param_specs(axes, shapes)
    experts = 0
    for path, shape in shapes.items():
        if sharding.is_expert_leaf(path, len(shape)):
            experts += 1
            want = jsharding._expert_spec(shape, DuckMesh(*mesh))
        else:
            want = jsharding._leaf_spec(shape, DuckMesh(*mesh),
                                        skip_dim0=len(shape) >= 2)
        assert got[path] == tuple(want), path
    assert experts == 3


# --------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------- #
def _batch(jc, seed=2, seq=256):
    return jbatch(JPipe(dataset="wlb_llm", context_len=seq, batch_per_host=2,
                        cp_size=1, strategy="flashcp",
                        vocab_size=jc.vocab_size, seed=1), seed)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_smoke_olmoe_loss_and_grads_match_jax(cf):
    jc, tc, jp, tp = _models(capacity_factor=cf)
    batch = _batch(jc)
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    ctx = jctx(jnp.asarray(batch["doc"]), jnp.asarray(batch["pos"]),
               attention_impl="xla", q_chunk=64)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtm.loss_fn(p, jc, ctx, jb, remat=True), has_aux=True)(jp)
    tb = batch_to_device(batch, "cpu")
    tctx = make_local_context(tb["doc"], tb["pos"], q_chunk=64)
    names = sorted(_flat(tp))
    leaves = dict(zip(names, _leaves(tp)))
    for t in leaves.values():
        t.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, tc, tctx, tb, remat=True)
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL)
    np.testing.assert_allclose(tmet["ce"].item(), float(jm["ce"]), rtol=TOL)
    np.testing.assert_allclose(tmet["aux"].item(), float(jm["aux"]),
                               rtol=TOL)
    assert tmet["aux"].item() > 0
    want = _flat(_np_tree(jg))
    for name, g in zip(names, tg):
        _close(g, want[name], 1e-4, name)
    # the chunked head adds the same aux
    hl, _ = tm.loss_fn_chunked_head(tp, tc, tctx, tb, chunk=64)
    np.testing.assert_allclose(hl.item(), tl.item(), rtol=TOL)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_smoke_dbrx_loss_and_grads_match_jax(impl):
    """dbrx_132b's MoE stack at its own GQA group (6: Hq 12 over Hkv 2,
    D 16, which reduce_for_smoke cuts to 4 / 2), its 16 experts and
    top-4, its capacity factor (1.25: tokens clipped), 4 smoke layers:
    loss, aux and gradients against the reference through the plain
    attention (its XLA oracle) and the kernels' twins (its Pallas
    kernels in interpret mode), at the olmoe test's bounds."""
    def cfg(mod):
        c = mod.get_config("dbrx_132b")
        return dataclasses.replace(mod.reduce_for_smoke(c), num_heads=12,
                                   num_kv_heads=2,
                                   num_experts=c.num_experts,
                                   top_k=c.top_k)
    jc, tc = cfg(jcfgs), cfg(tcfgs)
    jp = jinit(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    flash = impl == "flash"
    batch = _batch(jc)
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    ctx = jctx(jnp.asarray(batch["doc"]), jnp.asarray(batch["pos"]),
               attention_impl="pallas" if flash else "xla", interpret=True,
               q_chunk=64, grid="flat")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtm.loss_fn(p, jc, ctx, jb, remat=True), has_aux=True)(jp)
    tb = batch_to_device(batch, "cpu")
    tctx = make_local_context(tb["doc"], tb["pos"], attention_impl=impl,
                              q_chunk=64, grid="flat")
    names = sorted(_flat(tp))
    leaves = dict(zip(names, _leaves(tp)))
    for t in leaves.values():
        t.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, tc, tctx, tb, remat=True)
    tg = torch.autograd.grad(tl, list(leaves.values()))
    assert (tc.num_heads // tc.num_kv_heads, tc.num_experts, tc.top_k) \
        == (6, 16, 4)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=TOL)
    np.testing.assert_allclose(tmet["ce"].item(), float(jm["ce"]), rtol=TOL)
    np.testing.assert_allclose(tmet["aux"].item(), float(jm["aux"]),
                               rtol=TOL)
    want = _flat(_np_tree(jg))
    for name, g in zip(names, tg):
        _close(g, want[name], 1e-4, name)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #
def test_moe_prefill_routes_drop_free():
    """The port of tests/test_serve.py::test_moe_prefill_routes_drop_free:
    chunked prefill (drop-free routing) writes the KV that replaying the
    prompt through the decode path writes; and the same KV as the JAX
    prefill."""
    jc, tc, jp, tp = _models()
    rng = np.random.default_rng(0)
    B, Tp, S, C = 2, 12, 16, 4
    tokens = rng.integers(0, tc.vocab_size, (B, Tp)).astype(np.int32)
    cache_r = tm.init_cache(tc, B, S, device="cpu")
    for t in range(Tp):
        tm.decode_step(tp, tc, cache_r,
                       {"tokens": torch.from_numpy(tokens[:, t]).long()},
                       torch.full((B,), t, dtype=torch.int32),
                       attn_impl="dense")
    cache_p = tm.init_cache(tc, B, S, device="cpu")
    jcache = jtm.init_cache(jc, B, S)
    for c0 in range(0, Tp, C):
        pos = np.tile(np.arange(c0, c0 + C, dtype=np.int32), (B, 1))
        tm.prefill_forward(tp, tc, cache_p,
                           {"tokens": torch.from_numpy(
                               tokens[:, c0:c0 + C]).long()},
                           torch.from_numpy(pos), torch.ones((B, C),
                                                             dtype=bool))
        _, jcache = jtm.prefill_forward(
            jp, jc, jcache, {"tokens": jnp.asarray(tokens[:, c0:c0 + C])},
            jnp.asarray(pos), jnp.ones((B, C), bool))
    for n in ("k", "v"):
        kp = cache_p["sub_0"][n][:, :, :, :Tp].numpy()
        np.testing.assert_allclose(
            kp, cache_r["sub_0"][n][:, :, :, :Tp].numpy(), atol=1e-4,
            rtol=1e-4, err_msg=n)
        np.testing.assert_allclose(
            kp, np.asarray(jcache["sub_0"][n])[:, :, :, :Tp], atol=1e-5,
            rtol=0, err_msg=n)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_moe_decode_matches_forward_logits(impl):
    """Decode step by step (the flash path's plain twin, or the dense
    oracle) against the training forward's logits, at a drop-free
    capacity so neither clips: < 1e-4; the forward against the JAX
    forward at 1e-5 of its largest logit."""
    jc, tc, jp, tp = _models(capacity_factor=2.0)
    rng = np.random.default_rng(3)
    B, T = 2, 10
    tokens = rng.integers(0, tc.vocab_size, (B, T)).astype(np.int32)
    doc = np.zeros((B, T), np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    ctx = make_local_context(torch.from_numpy(doc), torch.from_numpy(pos))
    logits, _ = tm.forward(tp, tc, ctx,
                           {"tokens": torch.from_numpy(tokens).long()},
                           remat=False)
    jlogits, _ = jtm.forward(jp, jc, jctx(jnp.asarray(doc),
                                          jnp.asarray(pos)),
                             {"tokens": jnp.asarray(tokens)}, remat=False)
    _close(logits.detach(), jlogits, TOL, "forward")
    cache = tm.init_cache(tc, B, 16, device="cpu")
    for t in range(T):
        step, _ = tm.decode_step(
            tp, tc, cache, {"tokens": torch.from_numpy(tokens[:, t]).long()},
            torch.full((B,), t, dtype=torch.int32), attn_impl=impl)
        diff = (step - logits[:, t]).abs().max().item()
        assert diff < 1e-4, (t, diff)


def test_moe_engine_serves_both_layouts_like_jax():
    """The smoke olmoe served greedily on the port's CPU engine and on the
    JAX engine (Pallas interpret mode), paged and dense: the same
    tokens."""
    from repro.serve import ServeEngine as JaxEngine
    from repro_torch.serve import ServeEngine

    jc, tc, jp, tp = _models()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32)
               for n in (20, 13, 27)]
    geom = dict(num_slots=2, max_len=36, prefill_chunk=8, block_size=8)
    for layout in ("paged", "dense"):
        toks = []
        for eng in (JaxEngine(jc, params=jp, kv_layout=layout, **geom),
                    ServeEngine(tc, tp, device="cpu", kv_layout=layout,
                                **geom)):
            for p in prompts:
                eng.submit(p, max_new=6)
            res = eng.run()
            assert all(e["status"] == "ok" for e in res.values())
            toks.append({r: list(map(int, e["tokens"]))
                         for r, e in res.items()})
        assert toks[0] == toks[1], layout


# --------------------------------------------------------------------- #
# the expert-parallel island
# --------------------------------------------------------------------- #
EP_SCRIPT = r"""
import os, sys
N = int(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={N}"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax
import jax.numpy as jnp
from repro.compat import make_mesh, set_mesh
from repro.core.cp_attention import make_cp_context
from repro.planner import encode_plan_batch, get_planner

inp = np.load(sys.argv[2])
B, T = inp["x"].shape[:2]
plans = [get_planner("flashcp")(np.array([T]), N) for _ in range(B)]
stack, _ = encode_plan_batch(plans, align=8)
mesh = make_mesh((1, N), ("data", "model"))
with set_mesh(mesh):
    ctx = make_cp_context(mesh, {k: jnp.asarray(v) for k, v in stack.items()},
                          strategy="flashcp", impl="xla",
                          batch_axes=("data",), head_dim=8)
    ep = ctx.extras["ep_dispatch"]
    topi = jnp.asarray(inp["topi"])
    w = jnp.asarray(inp["w"])

    def f(x, gates, wi, wg, wo):
        p = {"router": jnp.zeros((x.shape[-1], wi.shape[0])), "wi": wi,
             "wg": wg, "wo": wo}
        return ep(x, topi, gates, p, kind="glu",
                  capacity_factor=float(inp["cf"]))

    args = tuple(jnp.asarray(inp[n]) for n in ("x", "gates", "wi", "wg",
                                                "wo"))
    out = jax.jit(f)(*args)
    g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * w),
                         argnums=(0, 1, 2, 3, 4)))(*args)
np.savez(sys.argv[4], out=np.asarray(out),
         **{n: np.asarray(v) for n, v in zip(
             ("dx", "dgates", "dwi", "dwg", "dwo"), g)})
"""


@pytest.mark.parametrize("n", [2, 4])
def test_ep_island_matches_reference(n, tmp_path):
    x, topi, gates, w, wi, wg, wo = mranks.ep_inputs()
    # each rank routes its own B x T/N tokens: the capacity clips
    t_loc = mranks.T // n
    cap = tmoe.capacity(mranks.B * t_loc, mranks.E, mranks.K, mranks.EP_CF)
    dropped = sum(
        max(0, int(c) - cap) for r in range(n) for c in np.bincount(
            topi[:, r * t_loc:(r + 1) * t_loc].reshape(-1),
            minlength=mranks.E))
    assert dropped > 0
    spawn_ranks(mranks.ep_rank, n, args=(n, str(tmp_path / "store"),
                                         str(tmp_path)),
                timeout=JOIN_TIMEOUT)
    per = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]
    got = {k: np.concatenate([p[k] for p in per], axis=1)
           for k in ("out", "dx", "dgates")}
    # rank r holds experts [r E/N, (r+1) E/N)
    got.update({k: np.concatenate([p[k] for p in per], axis=0)
                for k in ("dwi", "dwg", "dwo")})

    np.savez(tmp_path / "in.npz", x=x, topi=topi, gates=gates, w=w, wi=wi,
             wg=wg, wo=wo, cf=mranks.EP_CF)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", EP_SCRIPT, os.path.join(HERE, "..", "src"),
         str(tmp_path / "in.npz"), str(n), str(tmp_path / "ref.npz")],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(tmp_path / "ref.npz")
    for k in got:
        _close(got[k], want[k], TOL, k)
    # the clipping is the island's own: one rank's dispatch differs
    one = tmoe.local_ep_dispatch(
        torch.from_numpy(x), torch.from_numpy(topi), torch.from_numpy(gates),
        {"wi": torch.from_numpy(wi), "wg": torch.from_numpy(wg),
         "wo": torch.from_numpy(wo)}, kind="glu",
        capacity_factor=mranks.EP_CF)
    assert np.abs(one.numpy() - want["out"]).max() > 1e-3


# --------------------------------------------------------------------- #
# the ZeRO-3 step with EP over ``model``
# --------------------------------------------------------------------- #
MOE_RUN_KW = dict(lr=1e-3, warmup_steps=1, total_steps=4)
DROP_FREE = {"capacity_factor": 2.0}        # E / top_k of the smoke olmoe


PIPE_KW = dict(dataset="wlb_llm", context_len=256, batch_per_host=2,
               strategy="flashcp", seed=1, align=1, emit_tables=False,
               table_grid="flat", table_block_q=64, table_block_k=64)


def test_moe_train_step_2x2_matches_jax(tmp_path):
    import _torch_cp_ranks as ranks

    jc, _, jp, _ = _models(seed=1, **DROP_FREE)
    np.savez(tmp_path / "params.npz", **_flat(_np_tree(jp)))
    spawn_ranks(ranks.train_rank, 4,
                args=(4, str(tmp_path / "store"), str(tmp_path),
                      str(tmp_path / "params.npz"),
                      {"plain": PIPE_KW}, MOE_RUN_KW,
                      [("plain", "none")], (2, 2), ARCH, DROP_FREE),
                timeout=JOIN_TIMEOUT)
    # the reference: its step on one device, the same logical batch
    batch = jbatch(JPipe(**PIPE_KW, cp_size=1,
                         vocab_size=jc.vocab_size), 0)
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    ctx = jctx(jnp.asarray(batch["doc"]), jnp.asarray(batch["pos"]),
               attention_impl="xla", q_chunk=64)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtm.loss_fn(p, jc, ctx, jb, remat=True), has_aux=True)(jp)
    mesh = make_local_mesh(1, 1)
    bundle = jbuild(jc, mesh, JRun(arch=jc.name, attention_impl="xla",
                                   **MOE_RUN_KW),
                    ShapeConfig("t", 256, 2, "train"), q_chunk=64)
    keys = bundle.abstract_inputs[2]
    with set_mesh(mesh):
        jparams, _, jmet = jax.jit(bundle.fn)(
            jp, jadamw_init(jp),
            {k: jnp.asarray(v) for k, v in batch.items() if k in keys},
            jnp.asarray(0, jnp.int32))
    jgrads, jparams = _flat(_np_tree(jg)), _flat(_np_tree(jparams))
    for r in range(4):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        tag = f"rank {r}"
        for k, want in (("loss", jl), ("ce", jm["ce"]), ("aux", jm["aux"])):
            np.testing.assert_allclose(res[f"plain/none/{k}"], float(want),
                                       rtol=TOL, err_msg=f"{tag} {k}")
        for name, want in jgrads.items():
            _close(res[f"plain/none/grad/{name}"], want, 1e-4,
                   f"{tag} grad {name}")
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(res[f"plain/none/step/{k}"],
                                       float(jmet[k]), rtol=TOL,
                                       err_msg=f"{tag} step {k}")
        for name, want in jparams.items():
            np.testing.assert_allclose(res[f"plain/none/param/{name}"], want,
                                       atol=5e-5, rtol=0,
                                       err_msg=f"{tag} param {name}")
