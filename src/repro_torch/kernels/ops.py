"""Differentiable doc-masked attention ops (the port of the reference's
``repro.kernels.ops``).

* :func:`doc_flash_attention` — the three training kernels of
  :mod:`repro_torch.kernels.doc_attention` as ``torch.autograd.Function``s:
  the forward kernel, and a backward that computes
  ``delta = rowsum(dO · O)`` in f32 and runs the dQ and dKV kernels.
  ``partial=True`` returns ``(o, lse)`` with gradients through both: the
  lse cotangent folds into the backward's delta (``delta - dlse``), so the
  same backward kernels serve a merged objective exactly.
* :func:`doc_attention_plain` — chunked dense attention with the same
  doc-mask semantics, differentiated by ordinary autograd (the
  reference's ``doc_attention_xla``).  ``partial=True`` returns the raw
  online-softmax triple ``(o_unnormalized, m, l)`` in f32.

The two partial forms merge the same way: a normalized ``(o, lse)`` pair
is the triple ``(o, m=lse, l=1)``.
"""

from __future__ import annotations

import torch

from repro_torch.table_layout import GRID_TABLE_HALF

from . import doc_attention as da
from .ref import doc_mask

__all__ = ["doc_flash_attention", "doc_attention_plain"]


def _split_tables(tables: tuple, grid: str):
    """(fwd/dQ tables, dKV reverse tables) halves of the combined tuple.

    rect: (kv_idx, kv_nvis | q_idx, q_nvis)
    flat: (fq_row, fq_col, fq_flags | rq_row, rq_col, rq_flags)
    """
    half = GRID_TABLE_HALF[grid]
    if len(tables) != 2 * half:
        raise ValueError(f"grid={grid!r} needs {2 * half} table arrays, got "
                         f"{len(tables)}")
    return tables[:half], tables[half:]


class _DocFlash(torch.autograd.Function):
    """Flash attention forward/backward on the visit tables.  ``opts`` is
    ``(scale, block_q, block_k, grid, partial)``."""

    @staticmethod
    def forward(ctx, q, k, v, q_doc, q_pos, kv_doc, kv_pos, opts, *tables):
        scale, block_q, block_k, grid, partial = opts
        fwd_t, _ = _split_tables(tables, grid)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = da.flash_fwd(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                                fwd_t, scale=scale, block_q=block_q,
                                block_k=block_k, grid=grid)
        ctx.save_for_backward(q, k, v, out, lse, q_doc, q_pos, kv_doc,
                              kv_pos, *tables)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return (out, lse) if partial else out

    @staticmethod
    def backward(ctx, *grads):
        scale, block_q, block_k, grid, partial = ctx.opts
        q, k, v, out, lse, q_doc, q_pos, kv_doc, kv_pos, *tables = \
            ctx.saved_tensors
        fwd_t, rev_t = _split_tables(tuple(tables), grid)
        do = grads[0]
        dlse = grads[1] if partial else None
        do = torch.zeros_like(out) if do is None else do.contiguous()
        delta = torch.sum(do.float() * out.float(), dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        kw = dict(scale=scale, block_q=block_q, block_k=block_k, grid=grid)
        dq = da.flash_bwd_dq(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc,
                             kv_pos, fwd_t, **kw)
        dk, dv = da.flash_bwd_dkv(q, k, v, do, lse, delta, q_doc, q_pos,
                                  kv_doc, kv_pos, rev_t, **kw)
        return (dq, dk, dv, None, None, None, None, None,
                *(None for _ in tables))


def doc_flash_attention(q, k, v, q_doc, q_pos, kv_doc, kv_pos, tables, *,
                        scale: float | None = None,
                        block_q: int = da.DEFAULT_BLOCK_Q,
                        block_k: int = da.DEFAULT_BLOCK_K,
                        grid: str = "rect", partial: bool = False):
    """Document-masked causal flash attention (the training kernels).

    ``tables`` is a :class:`~repro_torch.kernels.doc_attention.BlockTables`
    or the matching tensor tuple for ``grid``: ``(kv_idx, kv_nvis, q_idx,
    q_nvis)`` for ``grid="rect"``, ``(fq_row, fq_col, fq_flags, rq_row,
    rq_col, rq_flags)`` for ``grid="flat"``.

    ``partial=True`` returns ``(o, lse)`` — the KV-subset-normalized output
    and its log-sum-exp (``-inf`` on rows with nothing visible) — for
    online-LSE merging; gradients flow through both.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if isinstance(tables, da.BlockTables):
        block_q, block_k = tables.block_q, tables.block_k
        tables = tables.flat_as_torch(q.device) if grid == "flat" \
            else tables.as_torch(q.device)
    else:
        tables = tuple(tables)
    opts = (float(scale), block_q, block_k, grid, partial)
    return _DocFlash.apply(q, k, v, q_doc, q_pos, kv_doc, kv_pos, opts,
                           *tables)


def doc_attention_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *,
                        scale: float | None = None, q_chunk: int = 512,
                        partial: bool = False):
    """Chunked dense attention with the doc-mask semantics of ``ref.py``.

    Chunking over the query axis bounds the live score tensor to
    ``(B, Hq, q_chunk, Tk)``.  ``partial=True`` returns the unnormalized
    online-softmax triple ``(o, m, l)`` in f32 (``m = -1e30`` on rows
    with nothing visible).
    """
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if Tq % q_chunk != 0:
        q_chunk = Tq
    kf = k.float()
    vf = v.float()
    outs = []
    for c0 in range(0, Tq, q_chunk):
        qc = q[:, :, c0:c0 + q_chunk].float().reshape(B, Hkv, G, q_chunk, D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kf) * scale
        mask = doc_mask(q_doc[:, c0:c0 + q_chunk], q_pos[:, c0:c0 + q_chunk],
                        kv_doc, kv_pos)[:, None, None]
        if partial:
            s = torch.where(mask, s, da.NEG)
            m = s.amax(dim=-1)
            p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
            l = p.sum(dim=-1)
            o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
            outs.append((o.reshape(B, Hq, q_chunk, D),
                         m.reshape(B, Hq, q_chunk), l.reshape(B, Hq, q_chunk)))
            continue
        s = torch.where(mask, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        o = torch.where(l > 0, o / torch.clamp(l, min=1e-30), 0.0)
        outs.append(o.reshape(B, Hq, q_chunk, D))
    if partial:
        return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))
    return torch.cat(outs, dim=2).to(q.dtype)
