"""The port's single-device training path against the JAX package, on
identical inputs: the same numpy batches, the reference's own parameters
converted leaf for leaf, float32 throughout.

The reference runs its attention through the XLA oracle or the Pallas
kernels in interpret mode; the port through its plain attention or the
kernels' twins (CPU tensors).  Tolerances, with their reasons:

* loss 1e-5 relative — one f32 CE mean over a few hundred tokens;
* gradients 1e-4 relative to each leaf's largest entry — f32 sums in
  another order through 4 layers of forward and backward;
* the optimizer alone, on identical gradients, 1e-6 — the same f32
  formula with fused multiply-adds;
* parameters after two training steps 5e-5 absolute — Adam divides each
  gradient entry by its own running magnitude, so an entry whose
  gradient sits near the f32 noise floor moves by up to lr·Δg/(|g|+eps);
  everything else agrees to ~1e-7.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.data.distributions as jdist
import repro.data.packing as jpack
import repro.optim as jopt
from repro.compat import set_mesh
from repro.configs.base import RunConfig as JRun, ShapeConfig
from repro.data.pipeline import PipelineConfig as JPipe, make_batch as jbatch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_train_step as jbuild
from repro.models import init_params as jinit
from repro.models.context import make_local_context as jctx
from repro.models.layers import chunked_lm_loss as jchunked
from repro.models.transformer import loss_fn as jloss
from repro_torch import configs as tcfgs
from repro_torch import optim as topt
from repro_torch.data import distributions as tdist
from repro_torch.data import packing as tpack
from repro_torch.data.pipeline import PipelineConfig as TPipe
from repro_torch.data.pipeline import make_batch as tbatch
from repro_torch.launch.steps import batch_to_device, build_train_step
from repro_torch.launch.train import build_parser, train
from repro_torch.models import loss_fn, make_local_context, params_from_numpy
from repro_torch.models.layers import chunked_lm_loss
from repro_torch.models.transformer import loss_fn_chunked_head

SEQ, BATCH = 256, 2


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


# smoke configs that keep an arch's GQA group, which reduce_for_smoke
# cuts (48 / 1 to 4 / 1, 36 / 4 and 64 / 8 to 4 / 2): (Hkv, Hq) at D 16
ARCH_GROUPS = {"granite_34b": (1, 48), "starcoder2_7b": (2, 18),
               "qwen3_32b": (2, 16)}


def _models(arch, seed=0, group=False):
    jc = jcfgs.reduce_for_smoke(jcfgs.get_config(arch))
    tc = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    if group:
        hkv, hq = ARCH_GROUPS[arch]
        jc, tc = (dataclasses.replace(c, num_heads=hq, num_kv_heads=hkv)
                  for c in (jc, tc))
    jp = jinit(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, params_from_numpy(_np_tree(jp), device="cpu")


def _pipe_kw(cfg, tables, grid="flat", batch=BATCH):
    return dict(dataset="wlb_llm", context_len=SEQ, batch_per_host=batch,
                cp_size=1, strategy="flashcp", vocab_size=cfg.vocab_size,
                seed=1, align=64 if tables else 1, emit_tables=tables,
                table_grid=grid, table_block_q=64, table_block_k=64)


def _assert_tree_close(got, want, rtol, what=""):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-6)
        np.testing.assert_allclose(g[k], w[k], atol=rtol * scale, rtol=0,
                                   err_msg=f"{what}{k}")


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dataset", sorted(jdist.DATASETS))
def test_distribution_and_packing_copies_match(dataset):
    for seed in range(3):
        a, b = jdist.make_rng(seed), tdist.make_rng(seed)
        assert [jdist.sample_doc_length(dataset, a) for _ in range(50)] == \
            [tdist.sample_doc_length(dataset, b) for _ in range(50)]
        a, b = jdist.make_rng(seed), tdist.make_rng(seed)
        np.testing.assert_array_equal(jpack.pack_sequence(dataset, 4096, a),
                                      tpack.pack_sequence(dataset, 4096, b))
    lens = np.asarray([5, 17, 1, 40])
    for x, y in zip(jpack.doc_ids_and_positions(lens),
                    tpack.doc_ids_and_positions(lens)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cp", [1, 2, 4, 8])
@pytest.mark.parametrize("strategy,dataset,grid,C,align", [
    ("flashcp", "wlb_llm", "flat", 4096, 128),
    ("flashcp", "pile", "rect", 1000, 128),
    ("llama3", "redpajama", "flat", 2048, 128),
    ("ring", "wlb_llm", "rect", 1024, 64),
    ("flashcp", "pile", "flat", 776, 1),
])
def test_make_batch_bit_identical(strategy, dataset, grid, C, align, cp):
    kw = dict(dataset=dataset, context_len=C, batch_per_host=2, cp_size=cp,
              strategy=strategy, vocab_size=512, seed=3, align=align,
              emit_tables=align > 1, table_grid=grid, table_block_q=align,
              table_block_k=align)
    for step in (0, 7):
        # both plan serially: on their thread pools (the default
        # planner_workers=0), which of two equal sequences plans first
        # (and so the cache's hit count) is a race
        a = jbatch(JPipe(**kw, planner_workers=1), step)
        b = tbatch(TPipe(**kw, planner_workers=1), step)
        assert sorted(set(a) - {"stats"}) == sorted(set(b) - {"stats"})
        assert any(k.startswith("tab_") for k in b) == (align > 1)
        for k in set(a) - {"stats"}:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, v in b["stats"].items():
            assert a["stats"][k] == v, k


def test_make_batch_refuses_cp_and_unknown_strategy():
    # CP sizes > 1 are planned now (test_make_batch_bit_identical); an
    # unknown strategy still fails fast, naming the available planners
    with pytest.raises(KeyError, match="available"):
        tbatch(TPipe(strategy="nope", context_len=256), 0)


# --------------------------------------------------------------------- #
# loss and gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,impl,group", [
    pytest.param(a, i, g, id=f"{a}-G{ARCH_GROUPS[a][1] // ARCH_GROUPS[a][0]}"
                 f"-{i}" if g else f"{a}-{i}")
    for a, g in (("starcoder2_3b", False), ("qwen3_32b", False),
                 ("granite_34b", True), ("starcoder2_7b", True),
                 ("qwen3_32b", True))
    for i in ("plain", "flash")])
def test_loss_and_grads_match_jax(arch, impl, group):
    """Smoke models (4 layers, D 16), the last three at their arch's GQA
    group (``ARCH_GROUPS``: 48, 9, 8)."""
    jc, tc, jp, tp = _models(arch, group=group)
    flash = impl == "flash"
    batch = jbatch(JPipe(**_pipe_kw(jc, False)), 2)
    doc, pos = batch["doc"], batch["pos"]
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    ctx = jctx(jnp.asarray(doc), jnp.asarray(pos),
               attention_impl="pallas" if flash else "xla", interpret=True,
               q_chunk=64, grid="flat")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss(p, jc, ctx, jb, remat=True), has_aux=True)(jp)

    tb = batch_to_device(batch, "cpu")
    tctx = make_local_context(tb["doc"], tb["pos"], attention_impl=impl,
                              q_chunk=64, grid="flat")
    leaves = [t.requires_grad_(True) for t in _flat_t(tp)]
    tl, tm = loss_fn(tp, tc, tctx, tb, remat=True)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), rtol=1e-5)
    assert tm["aux"].item() == 0.0
    _assert_tree_close(dict(zip(_flat(tp), tg)), _flat(_np_tree(jg)), 1e-4)


def _flat_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_t(tree[k])]
    return [tree]


def test_chunked_head_loss_matches_jax_and_loss_fn():
    jc, tc, jp, tp = _models("starcoder2_3b", seed=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 96, jc.d_model)).astype(np.float32)
    lab = rng.integers(-1, jc.vocab_size, (2, 96)).astype(np.int32)
    w = np.asarray(jp["lm_head"]["w"])
    want = float(jchunked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(lab),
                          chunk=32))
    got = chunked_lm_loss(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(lab), chunk=32).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    batch = batch_to_device(tbatch(TPipe(**_pipe_kw(tc, False)), 0), "cpu")
    ctx = make_local_context(batch["doc"], batch["pos"], q_chunk=64)
    a, _ = loss_fn(tp, tc, ctx, batch)
    b, _ = loss_fn_chunked_head(tp, tc, ctx, batch, chunk=64)
    np.testing.assert_allclose(b.item(), a.item(), rtol=1e-5)


# --------------------------------------------------------------------- #
# optimizer alone
# --------------------------------------------------------------------- #
def _opt_trees(dtype):
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (3, 40, 24)}, "b": (17,), "c": {"g": (5, 6)}}

    def mk(s, scale):
        if isinstance(s, dict):
            return {k: mk(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    params, grads = mk(shapes, 1.0), mk(shapes, 3.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), params)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), grads)
    return jp, jg


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_optimizer_matches_jax_in_place(dtype, monkeypatch):
    """Clip + schedule + two AdamW updates on identical gradients; the
    leaves are cut into several slices to exercise the sliced path."""
    monkeypatch.setattr("repro_torch.optim._slices.SLICE_ELEMS", 500)
    jp, jg = _opt_trees(dtype)
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert ("master" in ts) == (dtype == jnp.bfloat16)
    for step in range(2):
        tg = params_from_numpy(_np_tree(jg), device="cpu")
        jcl, jn = jopt.clip_by_global_norm(jg, 1.0)
        tcl, tn = topt.clip_by_global_norm(tg, 1.0)
        # a sum of ~4000 squares in another order: ~1e-6 of it
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-5)
        kw = dict(base_lr=1e-2, warmup_steps=1, total_steps=5)
        jlr = jopt.warmup_cosine(step + 1, **kw)
        tlr = topt.warmup_cosine(step + 1, **kw)
        np.testing.assert_allclose(tlr.item(), float(jlr), rtol=1e-6)
        jp, js = jopt.adamw_update(jp, jcl, js, lr=jlr)
        topt.adamw_update(tp, tcl, ts, lr=tlr)
    assert int(ts["count"]) == int(js["count"]) == 2
    for name in ("mu", "nu") + (("master",) if "master" in js else ()):
        _assert_tree_close(ts[name], _np_tree(js[name]), 1e-6, name + ".")
    got, want = _flat(tp), _flat(_np_tree(jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)


def test_schedule_copies_match():
    for step in (0, 1, 5, 50, 99, 100, 300):
        kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
        np.testing.assert_allclose(topt.warmup_cosine(step, **kw).item(),
                                   float(jopt.warmup_cosine(step, **kw)),
                                   rtol=1e-6)
    assert topt.constant(3, base_lr=0.5).item() == 0.5


# --------------------------------------------------------------------- #
# the training step
# --------------------------------------------------------------------- #
def _jax_steps(jc, jp, impl, accum, batches, run_kw):
    mesh = make_local_mesh(1, 1)
    run = JRun(arch=jc.name, attention_impl=impl, **run_kw)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    bundle = jbuild(jc, mesh, run, shape, q_chunk=64, block_q=64,
                    block_k=64, interpret=True, accum=accum)
    keys = bundle.abstract_inputs[2]
    fn = jax.jit(bundle.fn)
    params, opt = jp, jopt.adamw_init(jp)
    metrics = []
    with set_mesh(mesh):
        for step, b in enumerate(batches):
            jb = {k: jnp.asarray(v) for k, v in b.items() if k in keys}
            params, opt, m = fn(params, opt, jb, jnp.asarray(step, jnp.int32))
            metrics.append(jax.tree.map(float, m))
    return params, opt, metrics


@pytest.mark.parametrize("impl,accum", [("plain", 1), ("flash", 1),
                                        ("plain", 2)])
def test_two_train_steps_match_jax(impl, accum):
    jc, tc, jp, tp = _models("starcoder2_3b", seed=1)
    flash = impl == "flash"
    batches = [jbatch(JPipe(**_pipe_kw(jc, flash)), s) for s in range(2)]
    run_kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jparams, jopt_state, jmetrics = _jax_steps(
        jc, jp, "pallas" if flash else "xla", accum, batches, run_kw)

    run = tcfgs.RunConfig(arch=tc.name, attention_impl=impl, **run_kw)
    step_fn = build_train_step(tc, run, q_chunk=64, block_q=64, block_k=64,
                               accum=accum, device="cpu")
    state = topt.adamw_init(tp)
    for step, (b, jm) in enumerate(zip(batches, jmetrics)):
        m = step_fn(tp, state, batch_to_device(b, "cpu"), step)
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-5,
                                       err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(m["lr"]), jm["lr"], rtol=1e-6)
        assert int(m["tokens"]) == int(jm["tokens"])
        assert float(m["aux"]) == jm["aux"] == 0.0
    assert jmetrics[1]["lr"] > 0
    assert int(state["count"]) == int(jopt_state["count"]) == 2
    assert "master" not in state and "master" not in jopt_state
    for name, got, want in (("params", tp, jparams),
                            ("mu", state["mu"], jopt_state["mu"]),
                            ("nu", state["nu"], jopt_state["nu"])):
        g, w = _flat(got), _flat(_np_tree(want))
        for k in w:
            atol = 5e-5 if name == "params" else 1e-4 * max(
                float(np.abs(w[k]).max()), 1e-12)
            np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_train_cli_smoke_on_cpu_and_cuda_default_raises():
    args = build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "256",
         "--batch", "2", "--q-chunk", "64"])
    out = train(args)
    assert len(out["losses"]) == 3
    assert np.all(np.isfinite(out["losses"] + out["grad_norms"]))
    assert out["lrs"][0] == 0.0 and out["lrs"][1] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(build_parser().parse_args(["--smoke", "--steps", "1"]))
        cfg = tcfgs.reduce_for_smoke(tcfgs.get_config("starcoder2_3b"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_train_step(cfg, tcfgs.RunConfig())


def test_train_step_refuses_what_waits_for_later_slices():
    """Gradient compression, a data axis and the int8 KV wire run now
    (their parity is in tests/test_torch_zero.py, tests/test_torch_dp.py
    and tests/test_torch_int8_wire.py); an unknown KV wire and a CP plan
    without its process group are still refused."""
    cfg = tcfgs.reduce_for_smoke(tcfgs.get_config("starcoder2_3b"))
    assert callable(build_train_step(
        cfg, tcfgs.RunConfig(grad_compression="int8"), device="cpu"))
    from repro_torch.core.cp_attention import make_cp_context
    from repro_torch.launch.train import parse_mesh
    arrs = {"doc": torch.zeros((1, 8), dtype=torch.int32),
            "pos": torch.zeros((1, 8), dtype=torch.int32)}
    assert callable(make_cp_context(arrs, head_dim=16,
                                    kv_comm_dtype="int8").attn)
    with pytest.raises(ValueError, match="kv_comm_dtype"):
        make_cp_context(arrs, head_dim=16, kv_comm_dtype="fp8")
    assert parse_mesh("2x4") == (2, 4)
    assert parse_mesh("1x4") == (1, 4)
    # a 2x1 mesh is two ranks: train() alone (no mesh) refuses it
    with pytest.raises(ValueError, match="main\\(\\) starts the ranks"):
        train(build_parser().parse_args(["--smoke", "--device", "cpu",
                                          "--mesh", "2x1"]))
    # N > 1 needs this rank's process group
    with pytest.raises(ValueError, match="process group"):
        make_cp_context({**arrs, "send_idx": torch.full((1, 2, 128), -1)},
                        head_dim=16)


def test_train_cli_mesh_runs_cp_ranks(capfd):
    """``--mesh 1x2 --dist-backend gloo`` spawns two CPU ranks that log
    the same losses as one rank on the same seed; a CP mesh without a
    backend is refused."""
    from repro_torch.launch.train import main
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "256",
            "--batch", "1", "--q-chunk", "64"]
    main(argv)
    one = capfd.readouterr().out
    main(argv + ["--mesh", "1x2", "--dist-backend", "gloo"])
    two = capfd.readouterr().out

    def losses(out):
        return [float(line.split()[4]) for line in out.splitlines()
                if line.startswith("[train] step")]

    assert len(losses(one)) == 2
    np.testing.assert_allclose(losses(two), losses(one), rtol=1e-4)
    assert "comm_tok 0 " in one and "comm_tok 0 " not in two
    with pytest.raises(SystemExit):
        main(argv + ["--mesh", "1x2"])


# --------------------------------------------------------------------- #
# the CP train step over N gloo ranks
# --------------------------------------------------------------------- #
JOIN_TIMEOUT = 240


MESH_RUN_KW = dict(lr=1e-3, warmup_steps=1, total_steps=4)


@functools.lru_cache(maxsize=None)
def _jax_step0(impl: str, comp: str, rows: int = BATCH):
    """The JAX reference of :func:`check_mesh_step` for one case (the same
    for every mesh): step 0's loss, ce and gradients on the N = 1 batch
    of ``rows`` rows, and one train step's metrics and parameters, as
    numpy."""
    jc, _, jp, _ = _models("starcoder2_3b", seed=1)
    flash = impl == "flash"
    batch = jbatch(JPipe(**_pipe_kw(jc, flash, batch=rows)), 0)
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    ctx = jctx(jnp.asarray(batch["doc"]), jnp.asarray(batch["pos"]),
               attention_impl="xla", q_chunk=64)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss(p, jc, ctx, jb, remat=True), has_aux=True)(jp)
    jparams, _, jmetrics = _jax_steps(
        jc, jp, "pallas" if flash else "xla", 1, [batch],
        {**MESH_RUN_KW, "grad_compression": comp})
    return (float(jl), float(jm["ce"]), _flat(_np_tree(jg)), jmetrics[0],
            _flat(_np_tree(jparams)))


def check_mesh_step(mesh_shape, tmp_path, cases, rows=BATCH):
    """The port's train step on a ``mesh_shape`` mesh of gloo ranks (CPU,
    ZeRO-3; (data, model), or (pod, data, model)) on the mesh's batch of
    step 0 (``rows`` rows) against the JAX step on the same logical batch
    (its N = 1 batch: the same documents and tokens in packed order),
    from the reference's own parameters, for each (impl, gradient
    compression) case: every rank's shards exactly its slices of the
    whole leaves, loss 1e-5 relative, every whole gradient 1e-4 of its
    leaf's largest entry, and after one step the metrics and whole
    parameters at the bounds of test_two_train_steps_match_jax.  Every
    case runs in one spawn."""
    import _torch_cp_ranks as ranks
    from repro_torch.launch.ranks import spawn_ranks

    world = math.prod(mesh_shape)
    jc, _, jp, _ = _models("starcoder2_3b", seed=1)
    np.savez(tmp_path / "params.npz", **_flat(_np_tree(jp)))
    pipe_kw = {}
    for impl in {impl for impl, _ in cases}:
        kw = _pipe_kw(jc, impl == "flash", batch=rows)
        pipe_kw[impl] = {k: v for k, v in kw.items()
                         if k not in ("cp_size", "vocab_size")}
    spawn_ranks(ranks.train_rank, world,
                args=(world, str(tmp_path / "store"), str(tmp_path),
                      str(tmp_path / "params.npz"), pipe_kw, MESH_RUN_KW,
                      cases, mesh_shape),
                timeout=JOIN_TIMEOUT)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for impl, comp in cases:
        key = f"{impl}/{comp}"
        jl, jce, jgrads, jmetrics, jparams = _jax_step0(impl, comp, rows)
        for r, res in enumerate(got):
            tag = f"{key} mesh {mesh_shape} rank {r}"
            assert res[f"{key}/shards_exact"], tag
            np.testing.assert_allclose(res[f"{key}/loss"], jl, rtol=1e-5,
                                       err_msg=tag)
            np.testing.assert_allclose(res[f"{key}/ce"], jce, rtol=1e-5,
                                       err_msg=tag)
            for name, want in jgrads.items():
                scale = max(float(np.abs(want).max()), 1e-6)
                np.testing.assert_allclose(
                    res[f"{key}/grad/{name}"], want, atol=1e-4 * scale,
                    rtol=0, err_msg=f"{tag} grad {name}")
            for k in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(res[f"{key}/step/{k}"],
                                           jmetrics[k], rtol=1e-5,
                                           err_msg=f"{tag} step {k}")
            assert int(res[f"{key}/step/tokens"]) == int(jmetrics["tokens"])
            for name, want in jparams.items():
                np.testing.assert_allclose(res[f"{key}/param/{name}"], want,
                                           atol=5e-5, rtol=0,
                                           err_msg=f"{tag} param {name}")


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_train_step_matches_jax(cp, tmp_path):
    """The CP step on a 1 x ``cp`` mesh (ZeRO-3 over the CP ranks),
    plain and flash attention (the twins, flat tables), through
    :func:`check_mesh_step`."""
    check_mesh_step((1, cp), tmp_path,
                    [("plain", "none"), ("flash", "none")])
