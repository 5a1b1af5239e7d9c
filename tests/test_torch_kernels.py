"""The port's decode-attention wrappers against the JAX package.

Same numpy inputs through the JAX Pallas kernels (interpret mode, as the
JAX tests run them on the CPU) and through the port's wrappers on CPU
tensors, which run the kernels' plain PyTorch versions.  Everything is
float32; atol 1e-5 leaves room for the different summation order of a
tiled online softmax against a one-shot softmax (observed differences
are ~1e-7), while any masking, clamp or empty-row error is O(1).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cp_attention import finalize_partial as jax_finalize
from repro.core.cp_attention import merge_partials as jax_merge
from repro_torch.core.merge import NEG, finalize_partial, merge_partials

# the modules themselves (``repro.kernels`` re-exports a function of the
# same name as its flash_decode module)
jfd = importlib.import_module("repro.kernels.flash_decode")
tfd = importlib.import_module("repro_torch.kernels.flash_decode")

ATOL = 1e-5


def _qkv(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ragged lengths with the edge cases: empty (-1), a single token (0),
# the whole cache (S-1) and mid-cache values
S = 40
LENGTHS = np.asarray([-1, 0, S - 1, 17, 8], np.int32)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_normalized_matches_jax(G):
    Hkv, D = 2, 16
    q, k, v = _qkv(len(LENGTHS), G * Hkv, Hkv, S, D, seed=G)
    ref = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(LENGTHS), interpret=True)
    out = tfd.flash_decode(_t(q), _t(k), _t(v), _t(LENGTHS))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
    assert np.all(out.numpy()[0] == 0)          # the empty row is exactly 0


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_partial_matches_jax(G):
    Hkv, D = 2, 16
    q, k, v = _qkv(len(LENGTHS), G * Hkv, Hkv, S, D, seed=10 + G)
    jo, jm, jl = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(LENGTHS),
                                  interpret=True, partial=True)
    o, m, l = tfd.flash_decode(_t(q), _t(k), _t(v), _t(LENGTHS),
                               partial=True)
    assert o.dtype == m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), _np(jm), atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), _np(jl), atol=ATOL, rtol=1e-6)
    # the empty row is exactly the merge identity
    assert np.all(o.numpy()[0] == 0) and np.all(l.numpy()[0] == 0)
    assert np.all(m.numpy()[0] == np.float32(NEG))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_flash_decode_sharded_matches_jax(shards):
    q, k, v = _qkv(len(LENGTHS), 4, 2, S, 16, seed=20 + shards)
    ref = jfd.flash_decode_sharded(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(LENGTHS),
                                   shards=shards, interpret=True)
    out = tfd.flash_decode_sharded(_t(q), _t(k), _t(v), _t(LENGTHS),
                                   shards=shards)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("tile,pages_per_split", [(6, 1), (6, 2), (6, 3),
                                                  (6, 7), (16, 1), (16, 2)])
def test_dense_split_plain_matches_jax(tile, pages_per_split, partial):
    """The dense split-KV twin (per-split partials over tiles of the
    stripe, merged) against the Pallas flash_decode in both modes: tile 6
    leaves a ragged last tile of 4 positions (16: of 8), lengths -1, 0,
    S-1 and mid-cache values leave splits wholly past a length, and 7
    tiles of 6 in one split is one split per request."""
    q, k, v = _qkv(len(LENGTHS), 8, 2, S, 16, seed=30 + tile)
    args = tuple(jnp.asarray(x) for x in (q, k, v, LENGTHS))
    out = tfd.decode_split_plain(_t(q), _t(k), _t(v), _t(LENGTHS),
                                 tile=tile, pages_per_split=pages_per_split,
                                 partial=partial)
    if not partial:
        ref = jfd.flash_decode(*args, interpret=True)
        np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
        assert np.all(out.numpy()[0] == 0)
        return
    jo, jm, jl = jfd.flash_decode(*args, interpret=True, partial=True)
    o, m, l = out
    np.testing.assert_allclose(o.numpy(), _np(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), _np(jm), atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), _np(jl), atol=ATOL, rtol=1e-6)
    # the empty row is exactly the merge identity
    assert np.all(o.numpy()[0] == 0) and np.all(l.numpy()[0] == 0)
    assert np.all(m.numpy()[0] == np.float32(NEG))


@pytest.mark.parametrize("B,Hkv,S", [(6, 2, 1056), (1, 1, 33), (5, 2, 300),
                                     (64, 8, 4096), (3, 2, 77)])
def test_dense_split_plan_covers_the_stripe(B, Hkv, S):
    """Every tile of the stripe (the last one ragged) lies in exactly one
    split; splits are at least SPLIT_MIN_POSITIONS long unless the
    stripe is shorter; a small batch gets about SPLIT_BLOCKS_PER_SM
    blocks per SM.  At the serving shape (B 6, Hkv 2, S 1056) that is
    the paged kernel's 33 splits of 2 tiles of 16."""
    pps, n_split = tfd.dense_split_plan(B, Hkv, S, sms=132)
    nk = -(-S // tfd.DENSE_TILE)
    assert 1 <= pps <= nk and (n_split - 1) * pps < nk <= n_split * pps
    assert pps * tfd.DENSE_TILE >= min(tfd.SPLIT_MIN_POSITIONS, S)
    if B * Hkv * nk >= tfd.SPLIT_BLOCKS_PER_SM * 132 * pps:
        assert B * Hkv * n_split >= 132
    if (B, Hkv, S) == (6, 2, 1056):
        assert (tfd.DENSE_TILE, pps, n_split) == (16, 2, 33)


def _paged_case(seed=0):
    """A pool of 12 blocks of 4 tokens; five requests whose tables are a
    permutation of pool blocks, one block shared by two rows, unwritten
    table slots 0 and unwritten pool blocks 0, and one empty request."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D, bs, nb, nk = 5, 4, 2, 16, 4, 12, 6
    k_pool = np.zeros((Hkv, nb * bs, D), np.float32)
    v_pool = np.zeros((Hkv, nb * bs, D), np.float32)
    written = rng.permutation(nb)[:9]
    for blk in written:
        k_pool[:, blk * bs:(blk + 1) * bs] = rng.standard_normal((Hkv, bs, D))
        v_pool[:, blk * bs:(blk + 1) * bs] = rng.standard_normal((Hkv, bs, D))
    tables = np.zeros((B, nk), np.int32)
    tables[0, :3] = written[:3]
    tables[1, :4] = [written[0], written[3], written[4], written[5]]  # shares
    tables[2, :2] = written[6:8]
    tables[3, :6] = [written[8], written[7], written[6], written[5],
                     written[4], written[3]]
    lengths = np.asarray([10, 13, 5, nk * bs - 1, -1], np.int32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    return q, k_pool, v_pool, lengths, tables, bs


def test_flash_decode_paged_matches_jax():
    q, kp, vp, lengths, tables, bs = _paged_case()
    ref = jfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(lengths),
                                 jnp.asarray(tables), block_size=bs,
                                 interpret=True)
    out = tfd.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(lengths),
                                 _t(tables), block_size=bs)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
    assert np.all(out.numpy()[4] == 0)


@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 6])
def test_paged_split_plain_matches_jax(pages_per_split):
    """The split-KV twin (per-split partials, merged) against the Pallas
    paged kernel: a shared prefix block, a length of 0 and of -1, and
    (for small splits) splits wholly past a request's length.  6 = nk is
    one split per request."""
    q, kp, vp, lengths, tables, bs = _paged_case(seed=5)
    lengths[2] = 0
    ref = jfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(lengths),
                                 jnp.asarray(tables), block_size=bs,
                                 interpret=True)
    out = tfd.paged_decode_split_plain(_t(q), _t(kp), _t(vp), _t(lengths),
                                       _t(tables), block_size=bs,
                                       pages_per_split=pages_per_split)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)
    assert np.all(out.numpy()[4] == 0)


@pytest.mark.parametrize("B,Hkv,nk,bs", [(6, 2, 66, 16), (1, 1, 4, 16),
                                         (64, 8, 256, 16), (3, 2, 9, 8)])
def test_paged_split_plan_covers_the_table(B, Hkv, nk, bs):
    """Every table slot lies in exactly one split; splits are at least
    SPLIT_MIN_POSITIONS long unless the table is shorter; a small batch
    gets about SPLIT_BLOCKS_PER_SM blocks per SM."""
    pps, n_split = tfd.paged_split_plan(B, Hkv, nk, bs, sms=132)
    assert 1 <= pps <= nk and (n_split - 1) * pps < nk <= n_split * pps
    assert pps * bs >= min(tfd.SPLIT_MIN_POSITIONS, nk * bs)
    if B * Hkv * nk >= tfd.SPLIT_BLOCKS_PER_SM * 132 * pps:
        assert B * Hkv * n_split >= 132


def test_gather_paged_kv_matches_jax():
    _, kp, _, _, tables, bs = _paged_case(seed=3)
    ref = jfd.gather_paged_kv(jnp.asarray(kp), jnp.asarray(tables), bs)
    out = tfd.gather_paged_kv(_t(kp), _t(tables), bs)
    np.testing.assert_array_equal(out.numpy(), _np(ref))


def test_merge_and_finalize_match_jax():
    """Partials over disjoint KV subsets, one of them empty, fold and
    normalize as the JAX substrate does."""
    q, k, v = _qkv(len(LENGTHS), 4, 2, S, 16, seed=7)
    bounds = [(0, 9), (9, 30), (30, S)]
    tparts, jparts = [], []
    for lo, hi in bounds:
        ln = np.clip(LENGTHS - lo, -1, hi - lo - 1).astype(np.int32)
        tparts.append(tfd.flash_decode(_t(q), _t(k[:, :, lo:hi]),
                                       _t(v[:, :, lo:hi]), _t(ln),
                                       partial=True))
        jparts.append(tuple(jnp.asarray(x.numpy()) for x in tparts[-1]))
    merged = merge_partials(tparts)
    jmerged = jax_merge(jparts)
    for a, b in zip(merged, jmerged):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=ATOL, rtol=1e-6)
    out = finalize_partial(merged, torch.float32)
    np.testing.assert_allclose(out.numpy(),
                               _np(jax_finalize(jmerged, jnp.float32)),
                               atol=ATOL, rtol=0)
    ref = jfd.decode_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(LENGTHS))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor off the CPU never takes the plain path: mixed devices,
    or a device with no kernel, raise."""
    q, k, v = (_t(x) for x in _qkv(2, 4, 2, 8, 16))
    ln = _t(np.asarray([3, 5], np.int32))
    with pytest.raises(ValueError):
        tfd.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                         ln.to("meta"))
    with pytest.raises(ValueError):
        tfd.flash_decode(q, k.to("meta"), v, ln)
