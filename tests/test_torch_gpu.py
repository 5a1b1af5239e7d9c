"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  On a
machine with one (the H100 the port targets):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Shapes sweep what ``chip_smoke.py`` does not.  Decode kernels (both
split-KV): MHA (G 1) and wide groups (G 6, 8, 9, 12, 48), head dims 64
and 128, cache lengths that are not a multiple of the tile, shard slices
(strided views), block sizes 8 and 32, against the oracles and the
split twins, and the inputs the kernels refuse; tolerances f32 1e-5 (the
same arithmetic in another summation order), bf16 2e-2 on the normalized
output (bf16 rounding of the output and of p before PV).  Doc-attention
training kernels (flash_fwd, flash_bwd_dq, flash_bwd_dkv) against their
twins: G 1/2/3/6/8/9/12/48, D 64/128, blocks 32/48/64/128, flat and
rect, padded documents and all-empty rows, each bf16 forward asserted on
the kernel it takes (``fwd_wgmma_kernel`` where block_q, block_k and D
are each 64 or 128, else ``fwd_mma_kernel``), the wgmma forward's
masked and unmasked tiles; tolerances in ``DOC_TOL``
and, for the bf16 dQ and dK/dV, ``DQ_BF16_TOL`` and ``DKV_BF16_TOL``;
one CP hop's shape (Tq != Tk, the keys' own doc/pos, the partial op
with an lse cotangent); and the bf16 head dims the tensor-core kernels
refuse.
"""

import pytest
import torch

from repro_torch.core.merge import finalize_partial
from repro_torch.kernels import flash_decode as fd

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _lengths(S, B, gen):
    ln = torch.randint(0, S, (B,), generator=gen, device="cuda")
    ln[0], ln[-1] = -1, S - 1
    return ln.to(torch.int32)


def _check_dense(q, k, v, ln, tol):
    """The dense split-KV kernel in both modes against the oracles and
    the split twin at the wrapper's split; row 0 has length -1."""
    out = fd.flash_decode(q, k, v, ln)
    o, m, l = fd.flash_decode(q, k, v, ln, partial=True)
    torch.cuda.synchronize()
    ref = fd.decode_reference(q, k, v, ln).float()
    _, pm, pl = fd.decode_partial_reference(q, k, v, ln)
    B, Hkv, S = k.shape[:3]
    pps, _ = fd.dense_split_plan(B, Hkv, S, torch.cuda.get_device_properties(
        0).multi_processor_count)
    twin = fd.decode_split_plain(q, k, v, ln, tile=fd.DENSE_TILE,
                                 pages_per_split=pps, partial=True)
    fin = finalize_partial((o, m, l), torch.float32)
    assert (out.float() - ref).abs().max().item() <= tol
    assert (fin - ref).abs().max().item() <= tol
    assert (fin - finalize_partial(twin, torch.float32)).abs().max() \
        .item() <= tol
    assert torch.allclose(m[1:], pm[1:], atol=1e-5, rtol=0)
    assert torch.allclose(m, twin[1], atol=1e-5, rtol=0)
    assert torch.allclose(l[1:], pl[1:], atol=0, rtol=1e-5)
    assert torch.allclose(l[1:], twin[2][1:], atol=0, rtol=1e-5)
    assert bool((out[0] == 0).all() and (o[0] == 0).all()
                and (l[0] == 0).all() and (m[0] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,S", [(4, 4, 64, 77), (16, 2, 128, 300),
                                        (24, 2, 128, 1056), (8, 1, 64, 33),
                                        (12, 1, 128, 300), (48, 1, 128, 77),
                                        (48, 8, 128, 1040),
                                        (36, 4, 128, 300)])
def test_dense_kernel_matches_plain(gen, dtype, Hq, Hkv, D, S):
    """G 1, 6 (dbrx_132b's heads), 8, 9 (starcoder2_7b's), 12 and 48
    (MQA), S a multiple of the tile or not."""
    B = 5
    q = _randn(gen, (B, Hq, D), dtype)
    k = _randn(gen, (B, Hkv, S, D), dtype)
    v = _randn(gen, (B, Hkv, S, D), dtype)
    _check_dense(q, k, v, _lengths(S, B, gen), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernel_on_shard_slices(gen, dtype):
    """A shard of the cache is a strided view (batch and head strides of
    the whole cache): the split kernel reads it in both modes."""
    B, Hq, Hkv, D, S = 4, 8, 2, 64, 512
    k = _randn(gen, (B, Hkv, S, D), dtype)
    v = _randn(gen, (B, Hkv, S, D), dtype)
    q = _randn(gen, (B, Hq, D), dtype)
    ln = torch.tensor([-1, 100, 200, 255], dtype=torch.int32, device="cuda")
    ks, vs = k[:, :, 256:], v[:, :, 256:]
    assert not ks.is_contiguous()
    _check_dense(q, ks, vs, ln, TOL[dtype])


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_slices_match_plain(gen, shards):
    """Shard slices are strided views of the cache; the kernel reads them
    through their batch and head strides."""
    B, Hq, Hkv, D, S = 4, 8, 2, 64, 512
    q = _randn(gen, (B, Hq, D), torch.float32)
    k = _randn(gen, (B, Hkv, S, D), torch.float32)
    v = _randn(gen, (B, Hkv, S, D), torch.float32)
    ln = _lengths(S, B, gen)
    out = fd.flash_decode_sharded(q, k, v, ln, shards=shards)
    torch.cuda.synchronize()
    ref = fd.decode_reference(q, k, v, ln)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,G", [(8, 12), (16, 1), (32, 8)])
def test_paged_kernel_matches_plain(gen, dtype, bs, G):
    B, Hkv, D, nk = 4, 2, 128, 9
    nb = B * nk + 3
    kp = _randn(gen, (Hkv, nb * bs, D), dtype)
    vp = _randn(gen, (Hkv, nb * bs, D), dtype)
    perm = torch.randperm(nb, generator=gen, device="cuda")
    tables = perm[:B * nk].reshape(B, nk).to(torch.int32).contiguous()
    tables[1, :3] = tables[0, :3]                     # a shared prefix
    ln = torch.tensor([-1, 3 * bs - 1, nk * bs - 1, bs + 2],
                      dtype=torch.int32, device="cuda")
    tables[3, 2:] = 0                                 # unwritten slots
    q = _randn(gen, (B, G * Hkv, D), dtype)
    out = fd.flash_decode_paged(q, kp, vp, ln, tables, block_size=bs)
    torch.cuda.synchronize()
    ref = fd.paged_decode_reference(q, kp, vp, ln, tables, block_size=bs)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert bool((out[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 6, 8, 9, 12, 48])
def test_paged_split_kernel_matches_plain(gen, dtype, bs, G):
    """The split-KV kernel over long tables (many splits, splits past the
    shorter lengths, a shared prefix, lengths -1 and 0), G up to 48
    (MQA), the odd 9 among them, against the gather oracle and the split
    twin."""
    B, Hkv, D, nk = 5, 2 if G < 48 else 1, 128, 70
    nb = B * nk + 3
    kp = _randn(gen, (Hkv, nb * bs, D), dtype)
    vp = _randn(gen, (Hkv, nb * bs, D), dtype)
    perm = torch.randperm(nb, generator=gen, device="cuda")
    tables = perm[:B * nk].reshape(B, nk).to(torch.int32).contiguous()
    tables[1, :4] = tables[0, :4]                     # a shared prefix
    ln = torch.tensor([nk * bs - 1, 5 * bs + 3, -1, 0, 40 * bs],
                      dtype=torch.int32, device="cuda")
    q = _randn(gen, (B, G * Hkv, D), dtype)
    out = fd.flash_decode_paged(q, kp, vp, ln, tables, block_size=bs)
    torch.cuda.synchronize()
    ref = fd.paged_decode_reference(q, kp, vp, ln, tables, block_size=bs)
    pps, _ = fd.paged_split_plan(B, Hkv, nk, bs, torch.cuda.get_device_properties(0).multi_processor_count)
    twin = fd.paged_decode_split_plain(q, kp, vp, ln, tables, block_size=bs,
                                       pages_per_split=pps)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (out.float() - twin.float()).abs().max().item() <= TOL[dtype]
    assert bool((out[2] == 0).all())


def test_kernels_count_launches_and_refuse_what_they_cannot_take(gen):
    q = _randn(gen, (2, 4, 64), torch.float32)
    k = _randn(gen, (2, 2, 40, 64), torch.float32)
    ln = torch.tensor([10, 39], dtype=torch.int32, device="cuda")
    before = fd.flash_decode.launches
    fd.flash_decode(q, k, k, ln)
    assert fd.flash_decode.launches == before + 1
    with pytest.raises(ValueError):                    # int64 lengths
        fd.flash_decode(q, k, k, ln.long())
    with pytest.raises(TypeError):                     # mixed dtypes
        fd.flash_decode(q, k.to(torch.bfloat16), k, ln)
    with pytest.raises(TypeError):                     # no f16 kernel
        fd.flash_decode(q.half(), k.half(), k.half(), ln)
    with pytest.raises(ValueError):                    # rows not contiguous
        fd.flash_decode(q, _randn(gen, (2, 2, 64, 40), torch.float32)
                        .transpose(2, 3), k, ln)
    with pytest.raises(ValueError):                    # mixed devices
        fd.flash_decode(q.cpu(), k, k, ln)
    assert fd.flash_decode.launches == before + 1


# --------------------------------------------------------------------- #
# the doc-attention training kernels against their twins
# --------------------------------------------------------------------- #
# f32: the same products in another order, with the online softmax
# rescaled per 32-key sub-tile instead of per block (observed ~1e-6);
# bf16: outputs rounded to bf16 and p (forward) / dS (dQ) rounded to bf16
# at slightly different values
DOC_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the bf16 dQ kernel rounds where the twin does (dS before dS·K, and the
# output): what is left is the summation order, ex2.approx against exp,
# and the few dS that round to the other side of a bf16 tie
DQ_BF16_TOL = 1e-2
# the bf16 dK/dV kernel rounds only its outputs (Pᵀ and dSᵀ enter their
# products as hi + lo bf16 pairs): what is left is the summation order,
# ex2.approx against exp and the outputs' rounding
DKV_BF16_TOL = 1e-2


def _doc_layout(B, T, n_docs, pad, seed):
    """Sorted random documents, positions restarting per document, the
    last ``pad`` tokens padding (doc -1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    doc = np.sort(rng.integers(0, n_docs, (B, T)), 1).astype(np.int32)
    pos = np.zeros_like(doc)
    for b in range(B):
        for d in np.unique(doc[b]):
            m = doc[b] == d
            pos[b, m] = np.arange(m.sum())
    if pad:
        doc[:, -pad:] = -1
    return doc, pos


def _doc_case(gen, B, Hq, Hkv, T, D, bq, bk, dtype, pad, seed=0):
    from repro_torch.kernels.doc_attention import build_block_tables
    doc, pos = _doc_layout(B, T, 5, pad, seed)
    tabs = build_block_tables(doc, pos, doc, pos, block_q=bq, block_k=bk)
    meta = [torch.from_numpy(a).cuda() for a in (doc, pos, doc, pos)]
    q = _randn(gen, (B, Hq, T, D), dtype)
    k = _randn(gen, (B, Hkv, T, D), dtype)
    v = _randn(gen, (B, Hkv, T, D), dtype)
    do = _randn(gen, (B, Hq, T, D), dtype)
    return q, k, v, do, meta, tabs


def _takes_wgmma(dtype, bq, bk, D) -> bool:
    """Whether the forward runs on fwd_wgmma_kernel: bf16 with block_q,
    block_k and D each 64 or 128 (else fwd_mma_kernel, or in f32
    fwd_kernel)."""
    return dtype == torch.bfloat16 and {bq, bk, D} <= {64, 128}


def _halves(tabs, grid):
    t = tabs.flat_as_torch("cuda") if grid == "flat" \
        else tabs.as_torch("cuda")
    n = len(t) // 2
    return t[:n], t[n:]


def _maxerr(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("grid", ["flat", "rect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,bq,bk,T,pad", [
    (2, 2, 64, 64, 64, 512, 0),          # G 1
    (6, 2, 128, 128, 128, 768, 37),      # G 3, padded docs
    (24, 2, 128, 128, 128, 1024, 0),     # G 12, the training geometry
    (12, 1, 64, 64, 128, 512, 100),      # G 12, block_q != block_k
    (4, 1, 128, 128, 64, 384, 384),      # all rows empty
    (4, 2, 64, 48, 64, 384, 20),         # block_q 48: 16-row dK/dV units
    (4, 2, 128, 64, 32, 256, 10),        # block_k 32: the smallest sub-tile
    # the rest of the bf16 wgmma forward's shapes (block_q, block_k, D
    # each 64 or 128; one or two consumer warpgroups)
    (4, 2, 128, 64, 64, 512, 0),
    (4, 2, 128, 64, 128, 512, 0),
    (4, 2, 64, 128, 64, 512, 0),
    (4, 2, 64, 128, 128, 512, 15),
    (4, 2, 128, 128, 64, 512, 0),
    # the configured archs' heads at 2 x 4096 tokens, where the bf16
    # dK/dV splits the group as at one 8192-token row: 2, 12, 3, 2 slices
    (64, 8, 128, 128, 128, 4096, 0),     # qwen3_32b, G 8
    (48, 1, 128, 128, 128, 4096, 0),     # granite_34b, G 48 (MQA)
    (36, 4, 128, 128, 128, 4096, 0),     # starcoder2_7b, G 9
    (48, 8, 128, 128, 128, 4096, 0),     # dbrx_132b, G 6
])
def test_doc_kernels_match_twins(gen, grid, dtype, Hq, Hkv, D, bq, bk, T,
                                 pad):
    from repro_torch.kernels import doc_attention as da
    q, k, v, do, meta, tabs = _doc_case(gen, 2, Hq, Hkv, T, D, bq, bk,
                                        dtype, pad)
    fwd_t, rev_t = _halves(tabs, grid)
    kw = dict(scale=D ** -0.5, block_q=bq, block_k=bk, grid=grid)
    tol = DOC_TOL[dtype]
    before = da.flash_fwd.launches, da.flash_fwd.wgmma_launches
    o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    torch.cuda.synchronize()
    assert (da.flash_fwd.launches - before[0],
            da.flash_fwd.wgmma_launches - before[1]) \
        == (1, int(_takes_wgmma(dtype, bq, bk, D)))
    po, plse = da.flash_fwd_plain(q, k, v, *meta, fwd_t, **kw)
    assert _maxerr(o, po) <= tol
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))
    fin = torch.isfinite(plse)
    assert (lse[fin] - plse[fin]).abs().max().item() <= tol if fin.any() \
        else True
    empty = torch.isinf(plse)
    assert bool((o.float()[empty] == 0).all())

    delta = (do.float() * po.float()).sum(-1)
    dq = da.flash_bwd_dq(q, k, v, do, plse, delta, *meta, fwd_t, **kw)
    dk, dv = da.flash_bwd_dkv(q, k, v, do, plse, delta, *meta, rev_t, **kw)
    torch.cuda.synchronize()
    pdq = da.flash_bwd_dq_plain(q, k, v, do, plse, delta, *meta, fwd_t, **kw)
    pdk, pdv = da.flash_bwd_dkv_plain(q, k, v, do, plse, delta, *meta,
                                      rev_t, **kw)
    # gradients scale with the number of visible keys: relative bound
    def rel(got, want):
        return _maxerr(got, want) / max(want.float().abs().max().item(), 1.0)

    assert rel(dq, pdq) <= (DQ_BF16_TOL if dtype == torch.bfloat16 else tol)
    dkv_tol = DKV_BF16_TOL if dtype == torch.bfloat16 else tol
    assert rel(dk, pdk) <= dkv_tol
    assert rel(dv, pdv) <= dkv_tol
    if pad == T:
        assert not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("layout", ["one_document", "boundary_in_tile"])
@pytest.mark.parametrize("bq,bk,D", [(128, 128, 128), (64, 64, 64),
                                     (128, 64, 128), (64, 128, 64)])
def test_wgmma_forward_masks_only_where_it_must(gen, layout, bq, bk, D):
    """The bf16 wgmma forward skips the per-element mask on a warp's tile
    whose keys all lie in its rows' one document at or before their
    smallest position, and masks every other tile: one document over the
    whole row (the tiles below the diagonal interior, the diagonal ones
    masked), and documents that meet inside a tile (those tiles masked,
    their neighbours interior), both against the twin."""
    import numpy as np
    from repro_torch.kernels import doc_attention as da
    T = 1024
    lengths = [T] if layout == "one_document" else [200, 500, T - 700]
    doc = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lengths]).astype(np.int32)
    doc, pos = doc[None], pos[None]
    tabs = da.build_block_tables(doc, pos, doc, pos, block_q=bq, block_k=bk)
    meta = [torch.from_numpy(a).cuda() for a in (doc, pos, doc, pos)]
    q = _randn(gen, (1, 4, T, D), torch.bfloat16)
    k = _randn(gen, (1, 2, T, D), torch.bfloat16)
    v = _randn(gen, (1, 2, T, D), torch.bfloat16)
    fwd_t, _ = _halves(tabs, "flat")
    kw = dict(scale=D ** -0.5, block_q=bq, block_k=bk, grid="flat")
    before = da.flash_fwd.wgmma_launches
    o, lse = da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    torch.cuda.synchronize()
    assert da.flash_fwd.wgmma_launches == before + 1
    po, plse = da.flash_fwd_plain(q, k, v, *meta, fwd_t, **kw)
    assert torch.isfinite(plse).all() and torch.isfinite(lse).all()
    assert _maxerr(o, po) <= DOC_TOL[torch.bfloat16]
    assert (lse - plse).abs().max().item() <= DOC_TOL[torch.bfloat16]


def _hop_layout(Tq, Tk, n_docs, seed):
    """A CP hop's metadata: t_loc queries (documents' tails, positions
    starting past 0) against a gathered buffer of documents' heads
    (its own doc/pos, sorted, padding -1 at its end)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q_doc, q_pos = _doc_layout(1, Tq, n_docs, 0, seed)
    q_pos = q_pos + rng.integers(0, 300, n_docs)[q_doc].astype(np.int32)
    n_kv = Tk - Tk // 5
    # doc 0's queries see no key: empty rows
    kv_doc = np.sort(rng.integers(1, n_docs + 2, n_kv)).astype(np.int32)
    kv_pos = np.zeros_like(kv_doc)
    for d in np.unique(kv_doc):
        m = kv_doc == d
        kv_pos[m] = np.arange(m.sum())
    kv_doc = np.concatenate([kv_doc, np.full(Tk - n_kv, -1, np.int32)])
    kv_pos = np.concatenate([kv_pos, np.zeros(Tk - n_kv, np.int32)])
    return q_doc, q_pos, kv_doc[None], kv_pos[None]


@pytest.mark.parametrize("grid", ["flat", "rect"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,Tq,Tk,blk", [
    (24, 2, 128, 1024, 384, 128),        # the training heads, Tk < Tq
    (8, 2, 64, 256, 512, 64),            # Tk > Tq
])
def test_doc_kernels_at_a_hop_shape_in_partial_mode(gen, grid, dtype, Hq,
                                                    Hkv, D, Tq, Tk, blk):
    """One CP hop: Tq = t_loc queries against a gathered buffer of Tk
    keys with their own doc/pos, through the partial (o, lse) op with a
    nonzero lse cotangent, against the twins with dlse folded into
    delta as the op folds it."""
    from repro_torch.core.merge import NEG
    from repro_torch.kernels import doc_attention as da
    from repro_torch.kernels import ops as kops
    qd, qp, kd, kp = _hop_layout(Tq, Tk, 6, seed=Tq + Tk)
    tabs = da.build_block_tables(qd, qp, kd, kp, block_q=blk, block_k=blk)
    meta = [torch.from_numpy(a).cuda() for a in (qd, qp, kd, kp)]
    q = _randn(gen, (1, Hq, Tq, D), dtype).requires_grad_(True)
    k = _randn(gen, (1, Hkv, Tk, D), dtype).requires_grad_(True)
    v = _randn(gen, (1, Hkv, Tk, D), dtype).requires_grad_(True)
    do = _randn(gen, (1, Hq, Tq, D), dtype)
    dlse = _randn(gen, (1, Hq, Tq), torch.float32)
    before = da.flash_fwd.launches, da.flash_fwd.wgmma_launches
    o, lse = kops.doc_flash_attention(q, k, v, *meta, tabs, scale=D ** -0.5,
                                      grid=grid, partial=True)
    launched = da.flash_fwd.launches - before[0]
    assert launched >= 1 and da.flash_fwd.wgmma_launches - before[1] \
        == launched * _takes_wgmma(dtype, blk, blk, D)
    m = torch.clamp(lse, min=NEG)
    dq, dk, dv = torch.autograd.grad((o.float() * do.float()).sum()
                                     + (m * dlse).sum(), (q, k, v))
    torch.cuda.synchronize()
    fwd_t, rev_t = _halves(tabs, grid)
    kw = dict(scale=D ** -0.5, block_q=blk, block_k=blk, grid=grid)
    q, k, v = q.detach(), k.detach(), v.detach()
    po, plse = da.flash_fwd_plain(q, k, v, *meta, fwd_t, **kw)
    empty = torch.isinf(plse)
    assert 0 < int(empty.sum()) < empty.numel()
    delta = (do.float() * po.float()).sum(-1) \
        - torch.where(empty, 0.0, dlse)
    pdq = da.flash_bwd_dq_plain(q, k, v, do, plse, delta, *meta, fwd_t, **kw)
    pdk, pdv = da.flash_bwd_dkv_plain(q, k, v, do, plse, delta, *meta,
                                      rev_t, **kw)
    tol = DOC_TOL[dtype]
    bf16 = dtype == torch.bfloat16

    def rel(got, want):
        return _maxerr(got, want) / max(want.float().abs().max().item(), 1.0)

    assert _maxerr(o, po) <= tol
    assert torch.equal(torch.isinf(lse), empty)
    assert (lse[~empty] - plse[~empty]).abs().max().item() <= tol
    assert rel(dq, pdq) <= (DQ_BF16_TOL if bf16 else tol)
    assert rel(dk, pdk) <= (DKV_BF16_TOL if bf16 else tol)
    assert rel(dv, pdv) <= (DKV_BF16_TOL if bf16 else tol)


def test_doc_kernels_count_launches_and_refuse_what_they_cannot_take(gen):
    from repro_torch.kernels import doc_attention as da
    q, k, v, do, meta, tabs = _doc_case(gen, 1, 4, 2, 256, 64, 64, 64,
                                        torch.float32, 0)
    fwd_t, _ = _halves(tabs, "rect")
    kw = dict(scale=0.125, block_q=64, block_k=64, grid="rect")
    before = da.flash_fwd.launches
    da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    assert da.flash_fwd.launches == before + 1
    with pytest.raises(ValueError):                    # block_k not /32
        da.flash_fwd(q, k, v, *meta, fwd_t, **{**kw, "block_k": 16})
    with pytest.raises(ValueError):                    # not contiguous
        da.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                     *meta, fwd_t, **kw)
    with pytest.raises(TypeError):                     # no f16 kernel
        da.flash_fwd(q.half(), k.half(), v.half(), *meta, fwd_t, **kw)
    with pytest.raises(ValueError):                    # int64 tables
        da.flash_fwd(q, k, v, *meta, tuple(t.long() for t in fwd_t), **kw)
    with pytest.raises(ValueError):                    # mixed devices
        da.flash_fwd(q.cpu(), k, v, *meta, fwd_t, **kw)
    assert da.flash_fwd.launches == before + 1


def test_bf16_dkv_refuses_head_dims_off_the_tensor_cores(gen):
    """The bf16 dK/dV runs only on the tensor cores: a head dim that is
    not a multiple of 16 raises, and launches nothing; the same shape in
    f32 runs the scalar kernel."""
    from repro_torch.kernels import doc_attention as da
    q, k, v, do, meta, tabs = _doc_case(gen, 1, 4, 2, 256, 24, 64, 64,
                                        torch.bfloat16, 0)
    _, rev_t = _halves(tabs, "flat")
    kw = dict(scale=24 ** -0.5, block_q=64, block_k=64, grid="flat")
    lse = torch.zeros((1, 4, 256), dtype=torch.float32, device="cuda")
    delta = torch.zeros_like(lse)
    before = da.flash_bwd_dkv.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        da.flash_bwd_dkv(q, k, v, do, lse, delta, *meta, rev_t, **kw)
    assert da.flash_bwd_dkv.launches == before
    dk, dv = da.flash_bwd_dkv(q.float(), k.float(), v.float(), do.float(),
                              lse, delta, *meta, rev_t, **kw)
    torch.cuda.synchronize()
    assert da.flash_bwd_dkv.launches == before + 1
    assert dk.dtype == dv.dtype == torch.float32


def test_bf16_dq_refuses_head_dims_off_the_tensor_cores(gen):
    """The bf16 dQ runs only on the tensor cores: a head dim that is not
    a multiple of 16 raises, and launches nothing; the same shape in f32
    runs the scalar kernel."""
    from repro_torch.kernels import doc_attention as da
    q, k, v, do, meta, tabs = _doc_case(gen, 1, 4, 2, 256, 24, 64, 64,
                                        torch.bfloat16, 0)
    fwd_t, _ = _halves(tabs, "flat")
    kw = dict(scale=24 ** -0.5, block_q=64, block_k=64, grid="flat")
    lse = torch.zeros((1, 4, 256), dtype=torch.float32, device="cuda")
    delta = torch.zeros_like(lse)
    before = da.flash_bwd_dq.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        da.flash_bwd_dq(q, k, v, do, lse, delta, *meta, fwd_t, **kw)
    assert da.flash_bwd_dq.launches == before
    dq = da.flash_bwd_dq(q.float(), k.float(), v.float(), do.float(), lse,
                         delta, *meta, fwd_t, **kw)
    torch.cuda.synchronize()
    assert da.flash_bwd_dq.launches == before + 1
    assert dq.dtype == torch.float32


def test_bf16_forward_refuses_head_dims_off_the_tensor_cores(gen):
    """The bf16 forward runs only on the tensor cores: a head dim that is
    not a multiple of 16 raises instead of running another kernel."""
    from repro_torch.kernels import doc_attention as da
    q, k, v, _, meta, tabs = _doc_case(gen, 1, 4, 2, 256, 24, 64, 64,
                                       torch.bfloat16, 0)
    fwd_t, _ = _halves(tabs, "flat")
    kw = dict(scale=24 ** -0.5, block_q=64, block_k=64, grid="flat")
    before = da.flash_fwd.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        da.flash_fwd(q, k, v, *meta, fwd_t, **kw)
    q16, k16, v16, _, meta16, tabs16 = _doc_case(gen, 1, 4, 2, 256, 64, 64,
                                                 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="positive"):
        da.flash_fwd(q16, k16, v16, *meta16, _halves(tabs16, "flat")[0],
                     **{**kw, "scale": -0.125})
    assert da.flash_fwd.launches == before
    # the same shape in f32 runs the scalar kernel
    da.flash_fwd(q.float(), k.float(), v.float(), *meta, fwd_t, **kw)
    assert da.flash_fwd.launches == before + 1
