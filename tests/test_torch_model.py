"""The port's model against the JAX package on identical inputs.

The JAX model's own parameters, caches and inputs (numpy) go through
``repro.models`` and, converted with ``params_from_numpy``, through
``repro_torch.models`` on the CPU, whose decode attention is the
kernels' plain versions.  Everything is float32 at smoke size.  Logits
are held to atol 1e-4: both sides compute in fp32 but in different
summation orders over four layers (observed differences ~1e-6); a wrong
mask, position or cache write moves logits by O(0.1).  Written caches
are held to 1e-5 (one projection and a rotation away from the inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jm
from repro_torch import configs as tconfigs
from repro_torch import models as tm

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
DENSE_ARCHS = ["starcoder2_3b", "starcoder2_7b", "granite_34b", "qwen3_32b"]


def _cfgs(arch):
    return (jconfigs.reduce_for_smoke(jconfigs.get_config(arch)),
            tconfigs.reduce_for_smoke(tconfigs.get_config(arch)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return tm.params_from_numpy(_np_tree(tree), device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_copy_the_reference(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.param_count() == jc.param_count()
    js, ts = _cfgs(arch)
    for f in dataclasses.fields(ts):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name


def test_params_from_numpy_round_trip():
    jcfg, _ = _cfgs("qwen3_32b")
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    for tree in (params, jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                                      params)):
        ref = _leaves(_np_tree(tree))
        got = _leaves(_torch_tree(tree))
        assert got.keys() == ref.keys()
        for name, t in got.items():
            r = ref[name]
            assert tuple(t.shape) == r.shape, name
            assert str(t.dtype).split(".")[-1] == r.dtype.name, name
            np.testing.assert_array_equal(t.float().numpy(),
                                          r.astype(np.float32), name)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "qwen3_32b"])
def test_init_params_has_the_reference_layout(arch):
    jcfg, tcfg = _cfgs(arch)
    ref = _leaves(_np_tree(jm.init_params(jax.random.PRNGKey(0), jcfg)))
    got = _leaves(tm.init_params(tcfg, seed=0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: v.shape for k, v in ref.items()}
    # same seed -> same draw; norms start at one
    again = _leaves(tm.init_params(tcfg, seed=0, device="cpu"))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert torch.all(got["final_norm.g"] == 1)


def _setup(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = jm.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, _torch_tree(jparams)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "qwen3_32b"])
def test_dense_prefill_then_decode_match_jax(arch):
    """Chunked prefill into dense stripes (ragged prompts: the short row
    goes inactive mid-chunk), then decode steps with the flash path and
    the dense oracle, written caches and logits compared throughout."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    rng = np.random.default_rng(1)
    B, Tp, S, C = 2, 12, 24, 4
    lens = [Tp, 9]
    tokens = rng.integers(0, jcfg.vocab_size, (B, Tp)).astype(np.int32)
    jcache = jm.init_cache(jcfg, B, S)
    tcache = tm.init_cache(tcfg, B, S, device="cpu")
    for c0 in range(0, Tp, C):
        pos = np.tile(np.arange(c0, c0 + C, dtype=np.int32), (B, 1))
        active = np.stack([np.arange(c0, c0 + C) < n for n in lens])
        jl, jcache = jm.prefill_forward(
            jparams, jcfg, jcache, {"tokens": jnp.asarray(tokens[:, c0:c0 + C])},
            jnp.asarray(pos), jnp.asarray(active))
        tl, tcache = tm.prefill_forward(
            tparams, tcfg, tcache,
            {"tokens": torch.from_numpy(tokens[:, c0:c0 + C]).long()},
            torch.from_numpy(pos), torch.from_numpy(active))
        _close(tl[torch.from_numpy(active)], np.asarray(jl)[active],
               LOGIT_ATOL)
    for name in ("k", "v"):
        _close(tcache["sub_0"][name], jcache["sub_0"][name], CACHE_ATOL)

    # decode: row 1 continues at its own length, flash (sharded over 2
    # segments on the JAX side and the port's) and dense oracles agree
    pos_t = np.asarray([Tp, lens[1]], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B,)).astype(np.int32)
    for impl, shards in (("flash", 1), ("flash", 2), ("dense", 1)):
        tc = {j: {n: t.clone() for n, t in sub.items()}
              for j, sub in tcache.items()}
        jl, jc = jm.decode_step(jparams, jcfg, jcache,
                                {"tokens": jnp.asarray(tok)},
                                jnp.asarray(pos_t), attn_impl=impl,
                                attn_shards=shards)
        tl, tc = tm.decode_step(tparams, tcfg, tc,
                                {"tokens": torch.from_numpy(tok).long()},
                                torch.from_numpy(pos_t), attn_impl=impl,
                                attn_shards=shards)
        _close(tl, jl, LOGIT_ATOL)
        for name in ("k", "v"):
            _close(tc["sub_0"][name], jc["sub_0"][name], CACHE_ATOL)


@pytest.mark.parametrize("arch", ["starcoder2_3b", "qwen3_32b"])
def test_paged_prefill_then_decode_match_jax(arch):
    """One request prefilled chunk by chunk through a permuted block
    table (pow2 view buckets), then a batched decode step with an
    inactive row, against the JAX paged path."""
    jcfg, tcfg, jparams, tparams = _setup(arch, seed=2)
    rng = np.random.default_rng(3)
    bs, nb, nk, C, Tp = 4, 16, 6, 4, 14
    tokens = rng.integers(0, jcfg.vocab_size, (1, Tp)).astype(np.int32)
    table = np.zeros((1, nk), np.int32)
    table[0, :4] = [9, 2, 14, 5]
    jcache = jm.init_paged_cache(jcfg, nb, bs)
    tcache = tm.init_paged_cache(tcfg, nb, bs, device="cpu")
    for c0 in range(0, Tp, C):
        view = 1
        while view * bs < c0 + C:
            view *= 2
        view = min(view, nk)
        chunk = np.zeros((1, C), np.int32)
        n = min(C, Tp - c0)
        chunk[0, :n] = tokens[0, c0:c0 + n]
        pos = np.arange(c0, c0 + C, dtype=np.int32)[None]
        active = (np.arange(C) < n)[None]
        kw = dict(block_size=bs, view_blocks=view)
        jl, jcache = jm.prefill_forward(
            jparams, jcfg, jcache, {"tokens": jnp.asarray(chunk)},
            jnp.asarray(pos), jnp.asarray(active),
            block_tables=jnp.asarray(table), **kw)
        tl, tcache = tm.prefill_forward(
            tparams, tcfg, tcache, {"tokens": torch.from_numpy(chunk).long()},
            torch.from_numpy(pos), torch.from_numpy(active),
            block_tables=torch.from_numpy(table), **kw)
        _close(tl[0, :n], np.asarray(jl)[0, :n], LOGIT_ATOL)
    for name in ("k", "v"):
        _close(tcache["sub_0"][name], jcache["sub_0"][name], CACHE_ATOL)

    tables = np.zeros((3, nk), np.int32)
    tables[0] = table[0]
    tables[2, :2] = [7, 11]
    pos_t = np.asarray([Tp, 0, 5], np.int32)
    mask = np.asarray([True, False, True])
    tok = rng.integers(0, jcfg.vocab_size, (3,)).astype(np.int32)
    for impl in ("flash", "dense"):
        tc = {j: {n: t.clone() for n, t in sub.items()}
              for j, sub in tcache.items()}
        jl, jc = jm.decode_step(
            jparams, jcfg, jcache, {"tokens": jnp.asarray(tok)},
            jnp.asarray(pos_t), attn_impl=impl,
            block_tables=jnp.asarray(tables), block_size=bs,
            write_mask=jnp.asarray(mask))
        tl, tc = tm.decode_step(
            tparams, tcfg, tc, {"tokens": torch.from_numpy(tok).long()},
            torch.from_numpy(pos_t), attn_impl=impl,
            block_tables=torch.from_numpy(tables), block_size=bs,
            write_mask=torch.from_numpy(mask))
        _close(tl[mask], np.asarray(jl)[mask], LOGIT_ATOL)
        for name in ("k", "v"):
            _close(tc["sub_0"][name], jc["sub_0"][name], CACHE_ATOL)
