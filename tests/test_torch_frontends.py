"""The audio (musicgen) and VLM (internvl) frontends of the port against
the JAX package, on identical inputs: the reference's own parameters
converted leaf for leaf, the same numpy frames, patches and batches,
float32 throughout.

* Configs: every field, the analytic parameter counts and the
  parameter tree (the audio family has no embedding table).
* Training forward: loss 1e-5 relative, gradients 1e-4 of each leaf's
  largest entry (f32 sums in another order through 4 layers).
* Serving: cache-writing prefill with the request's frames and decode
  steps with frames, logits 1e-4 (as ``test_torch_model.py``), caches
  1e-5; the engines' greedy tokens identical with the prefix cache off.
* The CP step at 1x2 (gloo ranks, ZeRO-3) with the frames in the mesh's
  plan order, against the JAX step on the one-rank batch: loss 1e-5,
  gradients 1e-4.
* F5 (ROADMAP.md, Queue 3): the reference's prefix cache matches audio
  prompts on token ids alone; the port's audio prompts share no blocks,
  so its tokens equal a fresh engine's.
* F6: the port's training CLI refuses the two families (no data source
  makes their inputs) before any rank starts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro import models as jm
from repro.data.packing import doc_ids_and_positions
from repro.data.pipeline import PipelineConfig as JPipe, make_batch as jbatch
from repro.serve import ServeEngine as JaxEngine
from repro_torch import configs as tcfgs
from repro_torch import models as tm
from repro_torch.launch.train import main as train_main
from repro_torch.serve import ServeEngine
from _torch_frontend_ranks import frontend_inputs

ARCHS = ("musicgen_medium", "internvl2_1b")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5

torch.set_num_threads(1)


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
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _assert_grads(got: dict, want: dict, what: str = ""):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k], w, atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=f"{what}{k}")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jc = jcfgs.reduce_for_smoke(jcfgs.get_config(arch))
    tc = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, tm.params_from_numpy(_np_tree(jp), device="cpu")


# --------------------------------------------------------------------- #
# configs and parameters
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if smoke:
        jc, tc = jcfgs.reduce_for_smoke(jc), tcfgs.reduce_for_smoke(tc)
    for f in tc.__dataclass_fields__:
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tm.block_kinds(tc) == jm.block_kinds(jc)
    assert tm.supports_paged_cache(tc) and tm.supports_cached_prefill(tc)
    if not smoke:
        # the analytic count includes a vocab x d embedding table, which
        # the audio stack does not hold (1.362 B held)
        assert tc.param_count() == {"musicgen_medium": 1_365_393_408,
                                    "internvl2_1b": 629_635_328}[arch]


def test_params_tree_matches_reference(models):
    jc, tc, jp, tp = models
    mine = tm.init_params(tc, seed=0, device="cpu")
    want = {k: v.shape for k, v in _flat(_np_tree(jp)).items()}
    assert {k: v.shape for k, v in _flat(mine).items()} == want
    assert ("embed" in tp) == (tc.family != "audio") and "lm_head" in tp


# --------------------------------------------------------------------- #
# the training forward
# --------------------------------------------------------------------- #
def _model_batch(cfg, B=2, T=64, seed=0):
    """The reference's model-test batch (tests/test_models.py): two
    documents of 24 and 40 tokens per row, frames or patches drawn
    after the tokens."""
    rng = np.random.default_rng(seed)
    doc, pos = doc_ids_and_positions(np.array([24, 40]))
    doc = np.tile(doc, (B, 1)).astype(np.int32)
    pos = np.tile(pos, (B, 1)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = tokens.copy()
    labels[:, [23, 63]] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "audio_frames":
        batch["frame_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vit_patches":
        batch["patch_embeds"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
        pm = np.zeros((B, T), bool)
        pm[:, :cfg.num_patch_tokens] = True
        batch["patch_mask"] = pm
    return batch, doc, pos


def test_loss_and_grads_match_reference(models):
    jc, tc, jp, tp = models
    batch, doc, pos = _model_batch(tc)
    jctx = jm.make_local_context(jnp.asarray(doc), jnp.asarray(pos),
                                 q_chunk=32)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jc, jctx,
                             {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tctx = tm.make_local_context(torch.from_numpy(doc),
                                 torch.from_numpy(pos), q_chunk=32)
    leaves = [x for _, x in sorted(_flat_t(tp).items())]
    for x in leaves:
        x.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, tc, tctx,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["ce"].detach()), float(jmet["ce"]),
                               rtol=LOSS_RTOL)
    got = {k: g.numpy() for k, g in zip(sorted(_flat_t(tp)), grads)}
    _assert_grads(got, _flat(_np_tree(jg)))
    for x in leaves:
        x.requires_grad_(False)


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_t(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_frames_replace_tokens_and_patches_sit_under_the_mask(models):
    """The audio forward does not read tokens; the VLM forward reads
    patches only where the mask is set."""
    _, tc, _, tp = models
    batch, doc, pos = _model_batch(tc)
    ctx = tm.make_local_context(torch.from_numpy(doc), torch.from_numpy(pos),
                                q_chunk=32)

    def logits(b):
        return tm.forward(tp, tc, ctx,
                          {k: torch.from_numpy(v) for k, v in b.items()},
                          remat=False)[0]

    base = logits(batch)
    other = dict(batch, tokens=(batch["tokens"] + 1) % tc.vocab_size)
    if tc.frontend == "audio_frames":
        assert torch.equal(logits(other), base)
    else:
        pe = batch["patch_embeds"].copy()
        pe[~batch["patch_mask"]] += 1.0
        assert torch.equal(logits(dict(batch, patch_embeds=pe)), base)
        assert not torch.equal(logits(other), base)


# --------------------------------------------------------------------- #
# serving: prefill with frames, decode steps with frames
# --------------------------------------------------------------------- #
def _serve_inputs(cfg, n, rng):
    """``n`` positions of model inputs for two rows, as the engine feeds
    them (audio: frames; VLM: tokens with zero patches, unmasked)."""
    tokens = rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
    frames = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": frames}
    return {"tokens": tokens,
            "patch_embeds": np.zeros_like(frames),
            "patch_mask": np.zeros((2, n), bool)}


def _to_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_t(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def test_prefill_then_decode_match_reference(models):
    """Chunked cache-writing prefill (the second row short, inactive past
    its length) then decode steps, the audio family's with frames, the
    flash path (the kernels' plain versions) and the dense oracle."""
    jc, tc, jp, tp = models
    rng = np.random.default_rng(1)
    Tp, S, C = 12, 24, 4
    lens = [Tp, 9]
    inp = _serve_inputs(tc, Tp, rng)
    jcache = jm.init_cache(jc, 2, S)
    tcache = tm.init_cache(tc, 2, S, device="cpu")
    for c0 in range(0, Tp, C):
        chunk = {k: v[:, c0:c0 + C] for k, v in inp.items()}
        pos = np.tile(np.arange(c0, c0 + C, dtype=np.int32), (2, 1))
        active = np.stack([np.arange(c0, c0 + C) < n for n in lens])
        jl, jcache = jm.prefill_forward(jp, jc, jcache, _to_j(chunk),
                                        jnp.asarray(pos), jnp.asarray(active))
        tl, tcache = tm.prefill_forward(tp, tc, tcache, _to_t(chunk),
                                        torch.from_numpy(pos),
                                        torch.from_numpy(active))
        np.testing.assert_allclose(tl[torch.from_numpy(active)].numpy(),
                                   np.asarray(jl)[active], atol=LOGIT_ATOL,
                                   rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["sub_0"][name].numpy(),
                                   np.asarray(jcache["sub_0"][name]),
                                   atol=CACHE_ATOL, rtol=0)
    pos_t = np.asarray(lens, np.int32)
    for t in range(3):
        step = _serve_inputs(tc, 1, rng)
        one = {k: v[:, 0] for k, v in step.items()
               if k in ("tokens", "frame_embeds")}
        for impl in ("flash", "dense"):
            tcc = {j: {n: x.clone() for n, x in sub.items()}
                   for j, sub in tcache.items()}
            jl, jcc = jm.decode_step(jp, jc, jcache, _to_j(one),
                                     jnp.asarray(pos_t + t), attn_impl="dense")
            tl, tcc = tm.decode_step(tp, tc, tcc, _to_t(one),
                                     torch.from_numpy(pos_t + t),
                                     attn_impl=impl)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_ATOL, rtol=0,
                                       err_msg=f"step {t} {impl}")
        jcache, tcache = jcc, tcc


GEOM = dict(num_slots=2, prefill_chunk=8, block_size=8)
GEN = 5


def _requests(cfg):
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    out = []
    for n in (29, 20, 34):
        toks = np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                    n - 16)]).astype(np.int32)
        frames = rng.standard_normal((n, cfg.d_model)).astype(np.float32) \
            if cfg.frontend == "audio_frames" else None
        out.append((toks, frames))
    return out


def _serve(eng, reqs):
    for toks, frames in reqs:
        eng.submit(toks, max_new=GEN, frames=frames)
    out = eng.run()
    assert all(e["status"] == "ok" for e in out.values())
    return {r: e["tokens"].tolist() for r, e in out.items()}


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_tokens_match_reference(models, layout):
    """Greedy tokens of the two engines on the same requests (the audio
    prompts with their own frames), the prefix cache off."""
    jc, tc, jp, tp = models
    reqs = _requests(tc)
    max_len = 34 + GEN
    kw = dict(kv_layout=layout, prefix_cache=False, max_len=max_len, **GEOM)
    ref = _serve(JaxEngine(jc, params=jp, **kw), reqs)
    got = _serve(ServeEngine(tc, tp, device="cpu", **kw), reqs)
    assert got == ref


def test_audio_prompts_share_no_prefix_blocks():
    """F5: two audio prompts with the same 40 codec ids and different
    frames through one paged engine with the prefix cache (one slot,
    block 16, chunk 16).  The reference's second request reuses the
    first one's KV (its tokens differ from a fresh engine's); the port's
    matches no block and generates a fresh engine's tokens."""
    arch = "musicgen_medium"
    jc = jcfgs.reduce_for_smoke(jcfgs.get_config(arch))
    tc = tcfgs.reduce_for_smoke(tcfgs.get_config(arch))
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = tm.params_from_numpy(_np_tree(jp), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab_size, 40).astype(np.int32)
    fa, fb = (rng.standard_normal((40, tc.d_model)).astype(np.float32)
              for _ in range(2))
    kw = dict(num_slots=1, max_len=48, block_size=16, prefill_chunk=16)

    def run(make, frames_list):
        eng = make()
        return _serve(eng, [(toks, f) for f in frames_list]), eng

    jx = lambda: JaxEngine(jc, params=jp, **kw)             # noqa: E731
    tx = lambda: ServeEngine(tc, tp, device="cpu", **kw)    # noqa: E731
    ref_both, _ = run(jx, [fa, fb])
    ref_fresh, _ = run(jx, [fb])
    got_both, eng = run(tx, [fa, fb])
    got_fresh, _ = run(tx, [fb])
    assert got_both[1] == got_fresh[0] == ref_fresh[0]
    assert got_both[0] == ref_both[0]
    assert ref_both[1] != ref_fresh[0]          # the reference's F5
    assert eng.prefix.hits == 0 and eng.stats["prefill_cached_tokens"] == 0
    # token prompts keep the prefix cache
    eng = ServeEngine(tcfgs.reduce_for_smoke(tcfgs.get_config(
        "internvl2_1b")), device="cpu", **kw)
    _serve(eng, [(toks, None), (toks, None)])
    assert eng.stats["prefill_cached_tokens"] == 32


# --------------------------------------------------------------------- #
# the CP step with frames in plan order
# --------------------------------------------------------------------- #
PIPE_KW = dict(dataset="wlb_llm", context_len=256, batch_per_host=2,
               strategy="flashcp", seed=1, align=64, emit_tables=True,
               table_block_q=64, table_block_k=64)
RUN_KW = dict(lr=1e-3, warmup_steps=1, total_steps=4)
FRONTEND_SEED = 5


def test_cp_step_with_frontend_keys_in_plan_order(models, tmp_path):
    """1x2 mesh (gloo ranks, ZeRO-3, flash attention through the twins):
    each rank its CP token slice of the frames (or patches and mask) in
    the 1x2 plan order; against the JAX step on the one-rank batch of
    the same documents, whose frames go through its own plan order."""
    import _torch_frontend_ranks as ranks
    from repro_torch.launch.ranks import spawn_ranks

    jc, tc, jp, _ = models
    np.savez(tmp_path / "params.npz", **_flat(_np_tree(jp)))
    spawn_ranks(ranks.frontend_step_rank, 2,
                args=(2, str(tmp_path / "store"), str(tmp_path),
                      str(tmp_path / "params.npz"), tc.name, PIPE_KW,
                      RUN_KW, (1, 2), FRONTEND_SEED), timeout=240)
    batch = jbatch(JPipe(**PIPE_KW, cp_size=1, vocab_size=jc.vocab_size), 0)
    jb = {"tokens": batch["tokens"], "labels": batch["labels"],
          **frontend_inputs(tc, batch["perm"], FRONTEND_SEED)}
    ctx = jm.make_local_context(jnp.asarray(batch["doc"]),
                                jnp.asarray(batch["pos"]), q_chunk=64)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jc, ctx, _to_j(jb), remat=True),
        has_aux=True)(jp)
    want = _flat(_np_tree(jg))
    for r in range(2):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(res["loss"], float(jl), rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["ce"], float(jmet["ce"]),
                                   rtol=LOSS_RTOL)
        _assert_grads({k[5:]: v for k, v in res.items()
                       if k.startswith("grad/")}, want, f"rank {r} ")


def test_train_step_needs_the_frontend_keys(models):
    _, tc, _, tp = models
    from repro_torch.launch.steps import build_train_step
    step = build_train_step(tc, tcfgs.RunConfig(attention_impl="plain"),
                            device="cpu")
    batch, doc, pos = _model_batch(tc)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k in ("tokens", "labels")}
    batch.update(doc=torch.from_numpy(doc), pos=torch.from_numpy(pos))
    with pytest.raises(KeyError, match="the batch lacks"):
        step.loss_and_grads(tp, batch)


@pytest.mark.parametrize("arch,keys", [
    ("musicgen_medium", "frame_embeds"),
    ("internvl2_1b", "patch_embeds, patch_mask")])
def test_train_cli_refuses_frontend_archs(arch, keys, monkeypatch):
    """F6: the reference's CLI takes these archs and fails inside its
    first step; the port's refuses them before any rank starts, naming
    the inputs no data source makes."""
    import repro_torch.launch.train as tt

    def no_spawn(*_a, **_k):
        raise AssertionError("ranks spawned")

    monkeypatch.setattr(tt, "spawn_ranks", no_spawn)
    for argv in ([], ["--mesh", "2x2", "--dist-backend", "gloo"]):
        with pytest.raises(ValueError, match=keys):
            train_main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "1", *argv])
