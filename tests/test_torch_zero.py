"""The port's ZeRO-3 layer against the JAX package: the layout (the
reference's ``_leaf_spec`` and ``batch_specs``), the collectives over a
2x2 mesh of gloo ranks, gradient compression, and the bf16 embedding
gradient (ROADMAP F2).

The reference's sharding functions read only a mesh's ``axis_names``
and ``shape``, so they are handed a duck-typed mesh of any size.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_ranks as ranks
from repro.compat import make_abstract_mesh
from repro.configs import ARCHS as jARCHS
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit
from repro.models.layers import embed as jembed
from repro.optim import compress_tree as jcompress
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.models.layers import embed as tembed
from repro_torch.optim import compress_tree, global_norm
from repro_torch.runtime import sharding

jsharding = importlib.import_module("repro.runtime.sharding")

JOIN_TIMEOUT = 240
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4)]


class DuckMesh:
    """What the reference's sharding rules read of a mesh."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@functools.lru_cache(maxsize=1)
def full_width_shapes():
    """{path: shape} of full-width starcoder2_3b, abstractly."""
    cfg = jget_config("starcoder2_3b")
    tree = jax.eval_shape(lambda k: jinit(k, cfg), jax.random.PRNGKey(0))
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_layout_matches_reference_leaf_spec(mesh):
    axes = dict(zip(("data", "model"), mesh))
    shapes = full_width_shapes()
    got = sharding.param_specs(axes, shapes)
    for path, shape in shapes.items():
        want = jsharding._leaf_spec(shape, DuckMesh(*mesh),
                                    skip_dim0=len(shape) >= 2)
        assert got[path] == tuple(want), path
        # every split dim divides; a stacked leaf keeps its layers whole
        sh = sharding.shard_shape(shape, got[path], axes)
        assert all(a % b == 0 for a, b in zip(shape, sh) if b), path
        if path.startswith("layers/"):
            assert got[path][0] is None, path
    # the optimizer's 0-d count is whole everywhere
    assert sharding.param_specs(axes, {"count": ()}) == {"count": ()}


@pytest.mark.parametrize("mesh,rows", [((2, 2), 2), ((2, 2), 1),
                                       ((4, 1), 2), ((1, 4), 3)],
                         ids=["2x2-b2", "2x2-b1", "4x1-b2", "1x4-b3"])
def test_batch_rule_matches_reference(mesh, rows):
    """Rows over ``data`` (every data rank takes every row when they do
    not divide), tokens and the per-rank table axis over ``model``; and
    :func:`rank_batch` hands every rank its rows and token columns."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.steps import rank_batch

    axes = dict(zip(("data", "model"), mesh))
    pipe = PipelineConfig(context_len=256, batch_per_host=rows,
                          cp_size=mesh[1], vocab_size=512, align=16,
                          emit_tables=True, table_block_q=16,
                          table_block_k=16)
    batch = {k: v for k, v in make_batch(pipe, 0).items() if k != "stats"}
    shapes = {k: v.shape for k, v in batch.items()}
    got = sharding.batch_specs(axes, shapes)
    want = jsharding.batch_specs(DuckMesh(*mesh), shapes)
    assert got == {k: tuple(v) for k, v in want.items()}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    D, M = mesh
    split = rows % D == 0
    for d in range(D):
        for m in range(M):
            mine = rank_batch(tensors, axes, {"data": d, "model": m})
            r = slice(d * rows // D, (d + 1) * rows // D) if split \
                else slice(None)
            T = batch["tokens"].shape[1] // M
            np.testing.assert_array_equal(
                mine["tokens"], batch["tokens"][r, m * T:(m + 1) * T])
            np.testing.assert_array_equal(mine["doc"], batch["doc"][r])
            np.testing.assert_array_equal(mine["tab_loc_fq_flags"],
                                          batch["tab_loc_fq_flags"][r])


PROD_MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


def _spec(p) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in p)


@pytest.mark.parametrize("arch", sorted(jARCHS))
def test_param_specs_match_reference_at_production_meshes(arch):
    """Every full-width leaf of every arch (the expert leaves too) takes
    the reference's ``param_shardings`` spec at 16x16 and 2x16x16: the
    greedy order over ``data``, ``model`` and ``pod``."""
    cfg = jget_config(arch)
    tree = jax.eval_shape(lambda k: jinit(k, cfg), jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shapes = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in flat}
    for axes in PROD_MESHES:
        mesh = make_abstract_mesh(tuple(axes.values()), tuple(axes))
        specs = jax.tree_util.tree_flatten_with_path(
            jsharding.param_shardings(mesh, tree))[0]
        want = {"/".join(str(k.key) for k in path): _spec(x.spec)
                for path, x in specs}
        assert sharding.param_specs(axes, shapes) == want, axes


@pytest.mark.parametrize("axes,rows", [
    ({"pod": 2, "data": 1, "model": 2}, 2),
    ({"pod": 2, "data": 2, "model": 1}, 4),
    ({"pod": 2, "data": 2, "model": 1}, 2),
    ({"pod": 2, "data": 2, "model": 2}, 4)],
    ids=["2x1x2-b2", "2x2x1-b4", "2x2x1-b2", "2x2x2-b4"])
def test_batch_rule_with_pod_matches_reference(axes, rows):
    """Rows over ``pod`` and ``data`` (``pod`` the major one; every rank
    takes every row when they do not divide), as the reference's
    ``batch_specs`` on a two-pod mesh; :func:`rank_batch` hands every
    rank its rows and token columns."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.launch.steps import rank_batch

    P_, D, M = axes.values()
    pipe = PipelineConfig(context_len=256, batch_per_host=rows, cp_size=M,
                          vocab_size=512, align=16, emit_tables=True,
                          table_block_q=16, table_block_k=16)
    batch = {k: v for k, v in make_batch(pipe, 0).items() if k != "stats"}
    shapes = {k: v.shape for k, v in batch.items()}
    mesh = make_abstract_mesh(tuple(axes.values()), tuple(axes))
    want = jsharding.batch_specs(mesh, shapes)
    assert sharding.batch_specs(axes, shapes) == \
        {k: _spec(v) for k, v in want.items()}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    split = rows % (P_ * D) == 0
    n = rows // (P_ * D)
    T = batch["tokens"].shape[1] // M
    for p in range(P_):
        for d in range(D):
            for m in range(M):
                mine = rank_batch(tensors, axes,
                                  {"pod": p, "data": d, "model": m})
                g = p * D + d
                r = slice(g * n, (g + 1) * n) if split else slice(None)
                np.testing.assert_array_equal(
                    mine["tokens"], batch["tokens"][r, m * T:(m + 1) * T])
                np.testing.assert_array_equal(mine["doc"], batch["doc"][r])


@pytest.fixture(scope="module")
def zero_2x2(tmp_path_factory):
    """The ZeRO-3 collectives on 4 gloo ranks (one spawn)."""
    tmp = tmp_path_factory.mktemp("zero")
    spawn_ranks(ranks.zero_rank, 4, args=(4, str(tmp / "store"), str(tmp),
                                          (2, 2)), timeout=JOIN_TIMEOUT)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.numpy()}


def test_zero3_shards_gather_to_the_whole_leaves(zero_2x2):
    axes = {"data": 2, "model": 2}
    specs = sharding.param_specs(axes, ranks.SHAPES)
    whole = _flat(ranks.whole_tree(0))
    kinds = set()
    for r, res in enumerate(zero_2x2):
        coords = {"data": r // 2, "model": r % 2}
        for p, w in whole.items():
            np.testing.assert_array_equal(
                res[f"shard/{p}"], sharding.take_shard(w, specs[p], axes,
                                                       coords), err_msg=p)
            np.testing.assert_array_equal(res[f"whole/{p}"], w, err_msg=p)
            kinds.add(tuple(type(e).__name__ for e in specs[p]))
    # the leaves cover the kinds of entry a 2x2 mesh gives
    assert {("NoneType", "str", "str"), ("NoneType", "tuple"), ("tuple",),
            ("NoneType", "str"), ("NoneType",)} <= kinds


def test_ranks_holding_other_parameters_are_refused(zero_2x2):
    """``train``'s checksum against rank 0's (before each rank keeps its
    shards of the parameters it drew or restored): equal checksums pass,
    and every rank whose own differs raises."""
    for r, res in enumerate(zero_2x2):
        assert list(res["refused"]) == [False, r != 0], r


def test_zero3_gradient_is_the_sum_over_ranks(zero_2x2):
    """Each rank's loss is Σ whole * W_r: the gradient reaching every
    shard (reduce-scattered through the gathers, all-reduced over the
    axes its leaf is whole on) is its piece of Σ_r W_r."""
    axes = {"data": 2, "model": 2}
    specs = sharding.param_specs(axes, ranks.SHAPES)
    total = {p: sum(_flat(ranks.whole_tree(100 + r))[p] for r in range(4))
             for p in ranks.SHAPES}
    for r, res in enumerate(zero_2x2):
        coords = {"data": r // 2, "model": r % 2}
        for p, t in total.items():
            np.testing.assert_allclose(
                res[f"grad/{p}"], sharding.take_shard(t, specs[p], axes,
                                                      coords),
                rtol=1e-6, atol=1e-6, err_msg=p)


def test_zero3_clipped_global_norm_equals_unsharded(zero_2x2):
    total = {p: torch.from_numpy(sum(_flat(ranks.whole_tree(100 + r))[p]
                                     for r in range(4)))
             for p in ranks.SHAPES}
    want = float(global_norm(total))
    assert want > ranks.CLIP          # the clip scales
    for res in zero_2x2:
        np.testing.assert_allclose(float(res["norm"]), want, rtol=1e-6)
        for p, t in total.items():
            np.testing.assert_allclose(res[f"clipped/{p}"],
                                       t.numpy() * ranks.CLIP / want,
                                       rtol=1e-5, atol=1e-7, err_msg=p)


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_sharded_compression_equals_unsharded(zero_2x2, scheme):
    """int8's max|g| and topk's k-th largest |g| taken over every rank's
    shards give the compression of the whole leaves, exactly."""
    clipped = {p: torch.from_numpy(zero_2x2[0][f"clipped/{p}"])
               for p in ranks.SHAPES}
    want, _ = compress_tree(ranks.nest(list(clipped), clipped.values()),
                            None, scheme)
    want = _flat(want)
    for res in zero_2x2:
        for p in ranks.SHAPES:
            np.testing.assert_array_equal(res[f"{scheme}/{p}"], want[p],
                                          err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compress_tree_matches_reference(scheme, dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (37,), "b": (16, 24), "c": (3, 5, 7)}
    leaves_ = {k: rng.standard_normal(s).astype(np.float32) * 10 ** i
               for i, (k, s) in enumerate(shapes.items())}
    ef = {k: rng.standard_normal(s).astype(np.float32) * 0.1
          for k, s in shapes.items()}
    # ties at the topk threshold are kept by both
    leaves_["b"][0, :3] = np.abs(leaves_["b"]).max()
    jdt = jnp.dtype(dtype)
    jg = {k: jnp.asarray(v).astype(jdt) for k, v in leaves_.items()}
    jsent, jres = jcompress(jg, {k: jnp.asarray(v) for k, v in ef.items()},
                            scheme)
    tdt = getattr(torch, dtype)
    tg = {k: torch.from_numpy(v).to(tdt) for k, v in leaves_.items()}
    tsent, tres = compress_tree(
        tg, {k: torch.from_numpy(v) for k, v in ef.items()}, scheme)
    for k in shapes:
        np.testing.assert_array_equal(tsent[k].float().numpy(),
                                      np.asarray(jsent[k].astype(
                                          jnp.float32)), err_msg=k)
        np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                   rtol=0, atol=1e-6 * 10 ** 2, err_msg=k)
        assert tsent[k].dtype == tdt
    from repro.optim import wire_bytes as jwire
    from repro_torch.optim import ef_init, wire_bytes
    assert wire_bytes(tg, scheme) == jwire(jg, scheme)
    # no error feedback is zero error feedback, as the train step uses it
    zero_ef, _ = compress_tree(tg, ef_init(tg), scheme)
    none_ef, _ = compress_tree(tg, None, scheme)
    for k in shapes:
        assert torch.equal(zero_ef[k], none_ef[k])


def test_compression_refuses_unknown_schemes():
    with pytest.raises(ValueError, match="unknown gradient compression"):
        compress_tree({"a": torch.zeros(3)}, None, "fp8")


def test_bf16_embedding_grad_matches_reference_bit_for_bit():
    """ROADMAP F2: the gradient of a bf16 embedding table under a heavily
    repeated token rounds after every add in the reference on this CPU
    (jax.grad of ``take``) exactly as in the port: not a fault of the
    port.  Both lose the same ~16% against the exact sum."""
    rng = np.random.default_rng(0)
    V, d, n = 64, 32, 32768
    table = (rng.standard_normal((V, d)) * 0.02).astype(np.float32)
    ids = rng.choice(np.array([3, 17, 40, 41]), size=(2, n // 2),
                     p=[0.7, 0.1, 0.1, 0.1]).astype(np.int32)
    cot = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    jt, jc = (jnp.asarray(x, jnp.bfloat16) for x in (table, cot))
    _, vjp = jax.vjp(lambda e: jembed({"e": e}, jnp.asarray(ids),
                                      jnp.bfloat16), jt)
    jg = np.asarray(vjp(jc)[0])
    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = tembed({"e": tt}, torch.from_numpy(ids), torch.bfloat16)
    tg, = torch.autograd.grad(out, tt, torch.from_numpy(cot).to(
        torch.bfloat16))
    np.testing.assert_array_equal(tg.view(torch.int16).numpy(),
                                  jg.view(np.int16))
    exact = np.zeros((V, d))
    np.add.at(exact, ids.reshape(-1),
              np.asarray(jc.astype(jnp.float32)).reshape(-1, d))
    rel = np.linalg.norm(jg.astype(np.float32) - exact) \
        / np.linalg.norm(exact)
    assert rel > 0.05
