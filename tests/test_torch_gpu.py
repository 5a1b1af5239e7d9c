"""The CUDA flash-decode kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips.  On a
machine with one (the H100 the port targets):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Shapes sweep what ``chip_smoke.py`` does not: MHA (G 1) and wide groups
(G 8, 12), head dims 64 and 128, cache lengths that are not a multiple of
the tile, shard slices (strided views), block sizes 8 and 32, and the
inputs the kernels refuse.  Tolerances: f32 1e-5 (the same arithmetic in
another summation order), bf16 2e-2 on the normalized output (bf16
rounding of the output and of p before PV).
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D,S", [(4, 4, 64, 77), (16, 2, 128, 300),
                                        (24, 2, 128, 1056), (8, 1, 64, 33)])
def test_dense_kernel_matches_plain(gen, dtype, Hq, Hkv, D, S):
    B = 5
    q = _randn(gen, (B, Hq, D), dtype)
    k = _randn(gen, (B, Hkv, S, D), dtype)
    v = _randn(gen, (B, Hkv, S, D), dtype)
    ln = _lengths(S, B, gen)
    out = fd.flash_decode(q, k, v, ln)
    o, m, l = fd.flash_decode(q, k, v, ln, partial=True)
    torch.cuda.synchronize()
    ref = fd.decode_reference(q, k, v, ln).float()
    _, pm, pl = fd.decode_partial_reference(q, k, v, ln)
    tol = TOL[dtype]
    assert (out.float() - ref).abs().max().item() <= tol
    assert (finalize_partial((o, m, l), torch.float32) - ref).abs().max() \
        .item() <= tol
    assert torch.allclose(m[1:], pm[1:], atol=1e-5, rtol=0)
    assert torch.allclose(l[1:], pl[1:], atol=0, rtol=1e-5)
    assert bool((out[0] == 0).all() and (o[0] == 0).all()
                and (l[0] == 0).all() and (m[0] == -1e30).all())


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
