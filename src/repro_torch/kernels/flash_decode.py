"""Flash-decode attention: one query token vs a long KV cache.

Layout: q (B, Hq, D); dense cache k, v (B, Hkv, S, D); lengths (B,) int32,
inclusive (position t is visible iff t <= lengths[b]; the current token's
KV is already written at lengths[b]).  A negative length marks a request
with nothing visible: the output row is zeros and the partial is the
merge identity.

Wrappers and the kernels behind them (``csrc/flash_decode.cu``, built by
``_build`` at first use):

* :func:`flash_decode` — dense cache.  ``partial=False`` gives the
  normalized output (B, Hq, D); ``partial=True`` the merge-ready fp32
  ``(o, m, l)`` that :func:`repro_torch.core.merge.merge_partials`
  combines.  On the card it is split-KV flash decoding over tiles of
  ``DENSE_TILE`` positions of each stripe: one block per (b, kv head,
  split of ``pages_per_split`` tiles) writes an f32 partial, and a
  combine kernel merges them into either output
  (:func:`dense_split_plan` picks the split; :func:`decode_split_plain`
  is its plain form).
* :func:`flash_decode_sharded` — the cache's S axis split into shards,
  one partial each, merged on the online-LSE substrate.
* :func:`flash_decode_ranks` — the same across the ranks of a process
  group: each rank holds one S-slice of the cache, runs
  :func:`flash_decode` in partial mode on it, and the ranks merge with
  :func:`repro_torch.core.merge.merge_partials_axis` (the reference's
  ``tests/multidevice/decode_cp_check.py``).
* :func:`flash_decode_paged` — the KV lives in a global block pool
  (Hkv, num_blocks * block_size, D) and ``tables`` (B, nk) maps each
  request's logical block to its physical one.  On the card it is
  split-KV flash decoding: one block per (b, kv head, split of
  ``pages_per_split`` pages) writes an f32 partial, and a combine kernel
  merges them (:func:`paged_split_plan` picks the split;
  :func:`paged_decode_split_plain` is its plain form).

A wrapper given CPU tensors runs its plain PyTorch version below
(``decode_reference``, ``decode_partial_reference``,
``paged_decode_reference``); given CUDA tensors it launches its kernel or
raises.  Each kernel wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.comm import CPComm
from repro_torch.core.merge import (NEG, finalize_partial, merge_partials,
                                    merge_partials_axis)
from repro_torch.device import sm_count

__all__ = ["flash_decode", "flash_decode_sharded", "flash_decode_ranks",
           "local_lengths", "flash_decode_paged",
           "decode_reference", "decode_partial_reference",
           "paged_decode_reference", "paged_decode_split_plain",
           "paged_split_plan", "dense_split_plan", "decode_split_plain",
           "gather_paged_kv", "DENSE_TILE"]

#: KV positions per tile of the dense split kernel; any S works (the
#: ragged last tile is masked), so unlike the TPU kernel the tile never
#: shrinks to divide S
DENSE_TILE = 16
#: shared memory one block may use on Hopper
_SMEM_LIMIT = 232_448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the split of both split-KV kernels: at least this many positions per
#: split, and about this many blocks per SM (chosen by
#: scripts/paged_split_sweep.py)
SPLIT_MIN_POSITIONS = 32
SPLIT_BLOCKS_PER_SM = 4


# --------------------------------------------------------------------- #
# plain versions (the oracles, and the CPU path)
# --------------------------------------------------------------------- #
def _scores(q, k, lengths, scale):
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D) * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    visible = (pos[None, :] <= lengths[:, None].long())[:, None, None, :]
    return s, visible


def decode_reference(q, k, v, lengths, *, scale=None):
    """Dense softmax oracle.  q (B,Hq,D); k,v (B,Hkv,S,D); lengths (B,)."""
    B, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s, visible = _scores(q, k, lengths, scale)
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    out = torch.where((lengths >= 0)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_partial_reference(q, k, v, lengths, *, scale=None):
    """Plain form of the kernel's partial mode: the online softmax over
    the whole visible row as one tile.  Returns fp32 ``o`` (B,Hq,D)
    unnormalized, ``m`` and ``l`` (B,Hq); an empty row is (0, NEG, 0).
    p is rounded to V's dtype before the PV product, as in the kernel."""
    B, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s, visible = _scores(q, k, lengths, scale)
    m = s.masked_fill(~visible, NEG).amax(dim=-1)
    p = torch.where(visible, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


def gather_paged_kv(pool, tables, block_size: int):
    """Each request's logical KV view from the pool.  pool (Hkv, NBtok,
    D); tables (B, nk).  Returns (B, Hkv, nk * block_size, D).  Unwritten
    table slots point at block 0; their rows must be masked by
    position."""
    B, nk = tables.shape
    off = torch.arange(block_size, device=tables.device)
    phys = (tables.long()[:, :, None] * block_size + off).reshape(B, -1)
    return pool[:, phys].transpose(0, 1)


def paged_decode_reference(q, k_pool, v_pool, lengths, tables, *,
                           block_size: int, scale=None):
    """Gather + dense-softmax oracle for the paged kernel."""
    k = gather_paged_kv(k_pool, tables, block_size)
    v = gather_paged_kv(v_pool, tables, block_size)
    return decode_reference(q, k, v, lengths, scale=scale)


def paged_split_plan(B: int, Hkv: int, nk: int, block_size: int,
                     sms: int = 132) -> tuple[int, int]:
    """``(pages_per_split, n_split)`` of the split-KV paged kernel, from
    sizes the host knows (never from ``lengths``): enough splits that the
    B * Hkv * n_split blocks fill ``sms`` SMs about SPLIT_BLOCKS_PER_SM
    deep, each split at least SPLIT_MIN_POSITIONS positions long."""
    nk = max(nk, 1)
    pps = max(-(-SPLIT_MIN_POSITIONS // block_size),
              -(-B * Hkv * nk // (SPLIT_BLOCKS_PER_SM * sms)))
    pps = min(pps, nk)
    return pps, -(-nk // pps)


def dense_split_plan(B: int, Hkv: int, S: int,
                     sms: int = 132) -> tuple[int, int]:
    """``(pages_per_split, n_split)`` of the dense split-KV kernel over
    tiles of DENSE_TILE positions (the last one ragged): the paged rule
    on a stripe of ceil(S / DENSE_TILE) tiles."""
    return paged_split_plan(B, Hkv, -(-S // DENSE_TILE), DENSE_TILE, sms)


def decode_split_plain(q, k, v, lengths, *, tile: int, pages_per_split: int,
                       scale=None, partial: bool = False):
    """Plain form of the dense split-KV kernel: per split of
    ``pages_per_split`` tiles of ``tile`` positions (the last split
    ragged), the partial ``(o, m, l)`` against the split's local length
    (clamped; a split wholly past the length is the merge identity),
    merged with ``merge_partials``.  Returns the merged partial, or the
    normalized output in q's dtype."""
    S = k.shape[2]
    span = tile * pages_per_split
    parts = []
    for lo in range(0, S, span):
        hi = min(lo + span, S)
        local = torch.clamp(lengths - lo, -1, hi - lo - 1).to(torch.int32)
        parts.append(decode_partial_reference(q, k[:, :, lo:hi],
                                              v[:, :, lo:hi], local,
                                              scale=scale))
    merged = merge_partials(parts)
    return merged if partial else finalize_partial(merged, q.dtype)


def paged_decode_split_plain(q, k_pool, v_pool, lengths, tables, *,
                             block_size: int, pages_per_split: int,
                             scale=None):
    """Plain form of the split-KV paged kernel: the dense split twin
    over each request's gathered logical view, a tile per page."""
    k = gather_paged_kv(k_pool, tables, block_size)
    v = gather_paged_kv(v_pool, tables, block_size)
    return decode_split_plain(q, k, v, lengths, tile=block_size,
                              pages_per_split=pages_per_split, scale=scale)


# --------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------- #
def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_common(q, k, v, lengths, Hkv):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D), got {tuple(q.shape)}")
    B, Hq, D = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}; use float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 (B,) tensor")
    return B, Hq, D


def _check_aligned(D: int, *tensors) -> None:
    """The kernels stage K/V with 16-byte loads: rows of D elements and
    every base pointer and stride must keep 16-byte alignment."""
    esize = tensors[0].element_size()
    if (D * esize) % 16:
        raise ValueError(f"head dim {D} x {esize} bytes is not a multiple "
                         "of 16 bytes")
    for t in tensors:
        if t.data_ptr() % 16 or any(s * esize % 16 for s in t.stride()[:-1]):
            raise ValueError("k and v must be 16-byte aligned "
                             f"(strides {t.stride()})")


def _raise_on_error(lib, code: int, name: str) -> None:
    if code != 0:
        msg = lib.flash_decode_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _check_split(lib, G, D, tile, dtype):
    """What the split kernel cannot take: a head dim past its P V layout,
    or a block that needs more shared memory than an SM has."""
    if D > 512:
        raise ValueError(f"head dim {D} unsupported: at most 512")
    need = lib.flash_decode_split_smem_bytes(G, D, tile, _DTYPE_CODE[dtype])
    if need > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, tile={tile} needs {need} bytes of "
                         f"shared memory (limit {_SMEM_LIMIT})")


def _split_workspace(B, Hkv, n_split, G, D, device):
    """The f32 partials (o, m, l) of every split, written by the split
    kernel and read by the combine kernel."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, Hkv, n_split, G, D), **f32),
            torch.empty((B, Hkv, n_split, G), **f32),
            torch.empty((B, Hkv, n_split, G), **f32))


def flash_decode(q, k, v, lengths, *, scale=None, partial: bool = False):
    """q (B, Hq, D); k, v (B, Hkv, S, D); lengths (B,) int32.

    ``partial=False`` -> normalized output (B, Hq, D) in q's dtype.
    ``partial=True`` -> ``(o, m, l)``: fp32 accumulator (B, Hq, D), row
    max (B, Hq), row sum (B, Hq).
    """
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if _on_cpu(q, k, v, lengths):
        fn = decode_partial_reference if partial else decode_reference
        return fn(q, k, v, lengths, scale=scale)

    from ._build import flash_decode_lib

    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"k, v must be (B, Hkv, S, D) of one shape, got "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    _, Hkv, S, _ = k.shape
    B, Hq, D = _check_common(q, k, v, lengths, Hkv)
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name} rows must be contiguous (strides "
                             f"{t.stride()})")
    _check_aligned(D, k, v)
    G = Hq // Hkv
    lib = flash_decode_lib()
    _check_split(lib, G, D, DENSE_TILE, q.dtype)
    pps, n_split = dense_split_plan(B, Hkv, S, sm_count(q.device))
    if partial:
        out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
        om = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        ol = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
        om = ol = None
    part_o, part_m, part_l = _split_workspace(B, Hkv, n_split, G, D,
                                              q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_decode_dense(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if om is None else om.data_ptr(),
            None if ol is None else ol.data_ptr(),
            part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            B, Hkv, G, S, D, DENSE_TILE,
            k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            pps, n_split, float(scale), _DTYPE_CODE[q.dtype], int(partial),
            ctypes.c_void_p(stream))
    _raise_on_error(lib, code, "flash_decode")
    flash_decode.launches += 1
    return (out, om, ol) if partial else out


flash_decode.launches = 0


def flash_decode_sharded(q, k, v, lengths, *, shards: int, scale=None):
    """Decode attention over a sequence-sharded cache: shard s owns
    positions [s*S/N, (s+1)*S/N) and runs :func:`flash_decode` in partial
    mode against its local length (global length minus the shard
    offset, clamped); the partials merge through ``merge_partials`` and
    ``finalize_partial``.  ``shards=1`` is one partial plus finalize."""
    S = k.shape[2]
    if shards <= 0 or S % shards:
        raise ValueError(f"cannot split S={S} into {shards} shards")
    Sl = S // shards
    parts = []
    for s in range(shards):
        parts.append(flash_decode(
            q, k[:, :, s * Sl:(s + 1) * Sl], v[:, :, s * Sl:(s + 1) * Sl],
            local_lengths(lengths, s * Sl, Sl), scale=scale, partial=True))
    return finalize_partial(merge_partials(parts), q.dtype)


def local_lengths(lengths, offset: int, shard_len: int):
    """The inclusive lengths of a cache shard at positions [offset,
    offset + shard_len): the global length minus the offset, clamped to
    [-1, shard_len - 1] (-1: nothing of the row lies in the shard)."""
    return torch.clamp(lengths - offset, -1, shard_len - 1).to(torch.int32)


def flash_decode_ranks(q, k, v, lengths, *, comm: CPComm | None,
                       scale=None):
    """Decode attention over a cache whose S axis is split over the
    ranks of ``comm``: this rank holds positions [r*S_l, (r+1)*S_l) as
    ``k``, ``v`` (B, Hkv, S_l, D); ``q`` and the global ``lengths`` are
    the same on every rank.  One :func:`flash_decode` partial against
    the shard's local lengths, merged over the ranks by
    :func:`merge_partials_axis`; every rank returns the normalized
    output.  ``comm=None`` is one rank holding the whole cache."""
    rank = 0 if comm is None else comm.rank
    S_l = k.shape[2]
    part = flash_decode(q, k, v, local_lengths(lengths, rank * S_l, S_l),
                        scale=scale, partial=True)
    return finalize_partial(merge_partials_axis(part, comm), q.dtype)


def flash_decode_paged(q, k_pool, v_pool, lengths, tables, *,
                       block_size: int, scale=None):
    """Flash decode over a paged KV pool.

    q (B, Hq, D); k_pool, v_pool (Hkv, num_blocks * block_size, D);
    tables (B, nk) int32 physical block per logical block (slots past a
    request's length are never read, and must hold a valid block id,
    conventionally 0); lengths (B,) logical positions.  Returns the
    normalized output (B, Hq, D).
    """
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if _on_cpu(q, k_pool, v_pool, lengths, tables):
        return paged_decode_reference(q, k_pool, v_pool, lengths, tables,
                                      block_size=block_size, scale=scale)

    from ._build import flash_decode_lib

    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (Hkv, NBtok, D) of one shape, got "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    Hkv, nbtok, _ = k_pool.shape
    B, Hq, D = _check_common(q, k_pool, v_pool, lengths, Hkv)
    if k_pool.shape[2] != D or block_size <= 0 or nbtok % block_size:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)} / block_size {block_size}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("k_pool and v_pool must be contiguous")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != B or not tables.is_contiguous():
        raise ValueError("tables must be a contiguous int32 (B, nk) tensor")
    _check_aligned(D, k_pool, v_pool)
    G = Hq // Hkv
    nk = tables.shape[1]
    lib = flash_decode_lib()
    _check_split(lib, G, D, block_size, q.dtype)
    pps, n_split = paged_split_plan(B, Hkv, nk, block_size,
                                    sm_count(q.device))
    out = torch.empty_like(q)
    part_o, part_m, part_l = _split_workspace(B, Hkv, n_split, G, D,
                                              q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_decode_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
            part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            B, Hkv, G, nbtok, block_size, nk, D, pps, n_split, float(scale),
            _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _raise_on_error(lib, code, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
