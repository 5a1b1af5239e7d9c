"""GQA attention: the training block (projections, RoPE, the context's
doc-masked attention) and, for serving, KV-cache writes and the decode
and chunked-prefill attention over dense or paged caches.

The JAX package updates its caches functionally and relies on buffer
donation to do it in place, dropping inactive writes by routing them out
of bounds (``mode="drop"``).  Here every cache write is an in-place
indexed assignment into the caller's KV tensors, restricted to the
active rows or tokens: PyTorch has no drop mode, and an out-of-bounds
index on a CUDA tensor is a device fault.  The indices of the active
rows/tokens may be passed in precomputed (one host sync per model call
instead of one per layer).
"""

from __future__ import annotations

import torch

from repro_torch.core.merge import finalize_partial, merge_partials_axis
from repro_torch.kernels.flash_decode import (decode_partial_reference,
                                              decode_reference,
                                              flash_decode_paged,
                                              flash_decode_sharded,
                                              local_lengths,
                                              paged_decode_reference)
from repro_torch.kernels.ref import mha_reference
from .layers import rope

__all__ = ["attn_apply", "attn_cache_init", "attn_paged_cache_init", "attn_decode",
           "attn_decode_paged", "attn_prefill", "attn_prefill_paged"]


def _head_norm(x, g, eps):
    """Per-head RMS norm (qk_norm) over the head dimension."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


def _project(p, cfg, x):
    """x (B, T, d) -> q (B, Hq, T, hd), k, v (B, Hkv, T, hd)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(B, T, cfg.num_heads, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, T, cfg.num_kv_heads, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, T, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = _head_norm(q, p["q_norm"], cfg.norm_eps)
        k = _head_norm(k, p["k_norm"], cfg.norm_eps)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _qkv_roped(p, cfg, x, pos):
    q, k, v = _project(p, cfg, x)
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _out(p, out):
    return out @ p["wo"].to(out.dtype)


def attn_apply(p, cfg, ctx, x):
    """Training attention block: x (B, T, d) -> (B, T, d), with the
    context's attention over its plan-order doc/pos."""
    B, T, _ = x.shape
    q, k, v = _project(p, cfg, x)
    q = rope(q, ctx.pos, cfg.rope_theta)
    k = rope(k, ctx.pos, cfg.rope_theta)
    out = ctx.attn(q, k, v)                               # (B, Hq, T, hd)
    return _out(p, out.transpose(1, 2).reshape(
        B, T, cfg.num_heads * cfg.resolved_head_dim))


# ------------------------------------------------------------------ #
# caches
# ------------------------------------------------------------------ #
def attn_cache_init(cfg, periods: int, batch: int, max_len: int, dtype,
                    device):
    """Dense per-slot stripes (periods, B, Hkv, max_len, hd)."""
    shape = (periods, batch, cfg.num_kv_heads, max_len,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_paged_cache_init(cfg, periods: int, num_blocks: int,
                          block_size: int, dtype, device):
    """Global paged pool of one attention sub-layer, stacked over
    periods: (periods, Hkv, num_blocks * block_size, hd); physical
    position = block_id * block_size + offset."""
    shape = (periods, cfg.num_kv_heads, num_blocks * block_size,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ------------------------------------------------------------------ #
# dense stripes
# ------------------------------------------------------------------ #
def attn_decode(p, cfg, x_t, pos_t, cache, *, impl: str = "flash",
                shards: int = 1, write_rows=None, comm=None):
    """One decode token per row.  x_t (B, d); pos_t (B,) int32 current
    positions.  The new K/V land in place at ``cache[b, :, pos_t[b]]``
    for the rows in ``write_rows`` (default: every row).

    Every row attends with its own new K/V at ``pos_t``, as in the
    reference, which writes all rows and masks the cache update
    afterwards: the other rows' entries are written for the attention
    and put back after it.  Their outputs matter where rows interact (a
    MoE layer routes every row, so an idle row takes expert capacity).

    ``impl="flash"`` runs the flash-decode kernel per cache shard and
    merges the partials; ``"dense"`` is the softmax oracle.

    ``comm`` (a ``core.comm`` communicator over the ``model`` axis):
    ``cache`` is this rank's slice of a cache whose S axis is split over
    the group's ranks (``runtime.sharding.cache_specs``), positions
    ``[r S_l, (r+1) S_l)``; the rank holding ``pos_t`` writes the new
    K/V, each rank attends its slice densely in partial form, and the
    partials merge over the group (``merge_partials_axis``), as the
    reference's dense oracle runs on a sharded cache."""
    B, _ = x_t.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv_roped(p, cfg, x_t[:, None, :], pos_t[:, None])
    if comm is not None:
        return _attn_decode_split(p, cache, q, k, v, pos_t, comm,
                                  impl=impl, write_rows=write_rows,
                                  scale=hd ** -0.5)
    rows = torch.arange(B, device=x_t.device)
    at = pos_t.long()
    kept = None
    if write_rows is not None and write_rows.numel() < B:
        other = torch.ones(B, dtype=torch.bool, device=x_t.device)
        other[write_rows] = False
        idle = other.nonzero().flatten()
        kept = (idle, at[idle], cache["k"][idle, :, at[idle]].clone(),
                cache["v"][idle, :, at[idle]].clone())
    # in place, where the reference scatters functionally into a donated
    # buffer
    cache["k"][rows, :, at] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, at] = v[:, :, 0].to(cache["v"].dtype)

    q1 = q[:, :, 0].contiguous()
    if impl == "flash":
        out = flash_decode_sharded(q1, cache["k"], cache["v"], pos_t,
                                   shards=shards, scale=hd ** -0.5)
    elif impl == "dense":
        out = decode_reference(q1, cache["k"], cache["v"], pos_t,
                               scale=hd ** -0.5)
    else:
        raise ValueError(f"unknown decode attention impl {impl!r}")
    if kept is not None:
        idle, at_idle, k_old, v_old = kept
        cache["k"][idle, :, at_idle] = k_old
        cache["v"][idle, :, at_idle] = v_old
    return _out(p, out.reshape(B, -1).to(x_t.dtype)), cache


def _attn_decode_split(p, cache, q, k, v, pos_t, comm, *, impl, write_rows,
                       scale):
    """:func:`attn_decode` on this rank's S slice of a split cache."""
    if impl != "dense" or write_rows is not None:
        raise ValueError("a split cache decodes densely, every row")
    B = q.shape[0]
    S_l = cache["k"].shape[2]
    at = pos_t.long() - comm.rank * S_l
    mine = ((at >= 0) & (at < S_l))[:, None, None]
    at = at.clamp(0, S_l - 1)
    rows = torch.arange(B, device=q.device)
    for name, new in (("k", k), ("v", v)):
        old = cache[name][rows, :, at]
        cache[name][rows, :, at] = torch.where(
            mine, new[:, :, 0].to(old.dtype), old)
    part = decode_partial_reference(
        q[:, :, 0].contiguous(), cache["k"], cache["v"],
        local_lengths(pos_t, comm.rank * S_l, S_l), scale=scale)
    out = finalize_partial(merge_partials_axis(part, comm), q.dtype)
    return _out(p, out.reshape(B, -1)), cache


def attn_prefill(p, cfg, x, pos, cache, active, write_idx=None):
    """Chunked-prefill attention: write this chunk's KV into the cache
    in place, then attend the chunk's queries against the cache prefix.

    x (B, T, d); pos (B, T) global cache positions; active (B, T) bool:
    inactive tokens (padding past a short prompt) neither write nor
    produce output.  ``write_idx`` = ``active.nonzero(as_tuple=True)``
    if precomputed.  Returns (out (B, T, d), cache)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv_roped(p, cfg, x, pos)
    bi, ti = active.nonzero(as_tuple=True) if write_idx is None \
        else write_idx
    at = pos.long()[bi, ti]
    # in place, active tokens only (the reference drops the rest out of
    # bounds)
    cache["k"][bi, :, at] = k[bi, :, ti].to(cache["k"].dtype)
    cache["v"][bi, :, at] = v[bi, :, ti].to(cache["v"].dtype)

    S = cache["k"].shape[2]
    q_doc = torch.where(active, 0, -1).to(torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32,
                          device=x.device).expand(B, S)
    kv_doc = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    out = mha_reference(q, cache["k"], cache["v"], q_doc, pos, kv_doc,
                        kv_pos, scale=hd ** -0.5)
    return _out(p, out.transpose(1, 2).reshape(B, T, -1)), cache


# ------------------------------------------------------------------ #
# paged: block-table indirection into a global KV pool
# ------------------------------------------------------------------ #
def _phys_positions(tables, rows, pos, block_size: int):
    """Flat pool positions of logical positions ``pos`` (N,) of requests
    ``rows`` (N,) through the block table (B, nk).  Only written tokens
    are resolved, so no index ever leaves the table."""
    pos = pos.long()
    return tables.long()[rows, pos // block_size] * block_size \
        + pos % block_size


def attn_decode_paged(p, cfg, x_t, pos_t, cache, tables, active, *,
                      impl: str = "flash", block_size: int,
                      write_rows=None):
    """One decode token against the paged pool.  tables (B, nk) int32;
    active (B,) bool: inactive rows (idle or still prefilling) neither
    write the pool nor see any KV.  The caller has made each written
    block private (copy-on-write happens in the engine)."""
    B, _ = x_t.shape
    hd = cfg.resolved_head_dim
    q, k, v = _qkv_roped(p, cfg, x_t[:, None, :], pos_t[:, None])
    rows = active.nonzero().flatten() if write_rows is None else write_rows
    at = _phys_positions(tables, rows, pos_t[rows], block_size)
    # in-place pool write of the active rows only
    cache["k"][:, at] = k[rows, :, 0].transpose(0, 1).to(cache["k"].dtype)
    cache["v"][:, at] = v[rows, :, 0].transpose(0, 1).to(cache["v"].dtype)

    lengths = torch.where(active, pos_t, -1).to(torch.int32)
    q1 = q[:, :, 0].contiguous()
    if impl == "flash":
        out = flash_decode_paged(q1, cache["k"], cache["v"], lengths,
                                 tables, block_size=block_size,
                                 scale=hd ** -0.5)
    elif impl == "dense":
        out = paged_decode_reference(q1, cache["k"], cache["v"], lengths,
                                     tables, block_size=block_size,
                                     scale=hd ** -0.5)
    else:
        raise ValueError(f"unknown decode attention impl {impl!r}")
    return _out(p, out.reshape(B, -1).to(x_t.dtype)), cache


def attn_prefill_paged(p, cfg, x, pos, cache, active, tables, *,
                       block_size: int, view_blocks: int, write_idx=None):
    """Chunked-prefill attention through the block table (B = 1).

    Writes the chunk's roped KV at its physical pool positions, then
    attends the chunk's queries against the request's gathered logical
    prefix of ``view_blocks`` blocks."""
    B, T, _ = x.shape
    if B != 1:
        raise ValueError("paged prefill runs one request at a time")
    hd = cfg.resolved_head_dim
    q, k, v = _qkv_roped(p, cfg, x, pos)
    bi, ti = active.nonzero(as_tuple=True) if write_idx is None \
        else write_idx
    at = _phys_positions(tables, bi, pos[bi, ti], block_size)
    # in-place pool write of the active tokens only
    cache["k"][:, at] = k[0][:, ti].to(cache["k"].dtype)
    cache["v"][:, at] = v[0][:, ti].to(cache["v"].dtype)

    S = view_blocks * block_size
    s_log = torch.arange(S, dtype=torch.int32, device=x.device)
    vphys = tables[0].long()[s_log.long() // block_size] * block_size \
        + s_log.long() % block_size
    kv_k, kv_v = cache["k"][:, vphys][None], cache["v"][:, vphys][None]
    q_doc = torch.where(active, 0, -1).to(torch.int32)
    kv_pos = s_log.expand(B, S)
    kv_doc = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    out = mha_reference(q, kv_k, kv_v, q_doc, pos, kv_doc, kv_pos,
                        scale=hd ** -0.5)
    return _out(p, out.transpose(1, 2).reshape(B, T, -1)), cache
