"""Context-parallel attention context, at one device (the port of the
reference's ``repro.core.cp_attention``, N = 1 slice).

Every strategy runs on the partial-attention + online-LSE merge
substrate (:mod:`repro_torch.core.merge`): attention against a KV subset
yields a merge-ready partial ``(o, m, l)``, and the flash kernels' ``(o,
lse)`` form is the triple ``(o, m=lse, l=1)``.  With ``overlap="chunked"``
a rank attends its local KV first and then each of the N-1 arriving
buffers; at N = 1 there are no hops, so the step is the local partial,
finalized.

``impl`` picks the kernel: ``"flash"`` runs the CUDA training kernels
over the pipeline's ``tab_loc_*`` visit tables (the reference's
``"pallas"``); ``"plain"`` the chunked dense attention (its ``"xla"``).
The CP islands on ``torch.distributed`` (N > 1) and the monolithic
``overlap="none"`` islands are the next slice of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.models.context import ExecContext
from repro_torch.table_layout import table_keys
from .merge import NEG, finalize_partial

__all__ = ["make_cp_context", "resolve_overlap", "STRATEGIES"]

#: execution strategies the step builders hand to the context
STRATEGIES = ("flashcp", "contiguous", "allgather", "llama3", "per_doc",
              "ring", "ring_zigzag")
_CP_SLICE = ("context parallelism over N > 1 ranks (the CP islands on "
             "torch.distributed) is the next slice of the port")


def resolve_overlap(strategy: str, impl: str, overlap: str) -> str:
    """Effective overlap mode for (strategy, impl).  Ring has no
    monolithic kernel form, so ring + flash upgrades ``"none"`` to
    ``"chunked"``; the one rule for table emission and the context."""
    if overlap not in ("none", "chunked"):
        raise ValueError(f"unknown overlap mode {overlap!r}")
    if strategy in ("ring", "ring_zigzag") and impl == "flash":
        return "chunked"
    return overlap


def _partial_masked_attention(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *,
                              impl, scale, q_chunk, tables=None,
                              block_q=128, block_k=128, grid="rect"):
    """Merge-ready partial against one KV subset, on either kernel.

    The flash kernels emit ``(o, lse)``, re-expressed as ``(o, m=lse,
    l=1)``.  ``lse`` is clamped to the finite ``NEG`` so empty rows weigh
    exp(NEG - M) = 0 in a merge, and the clamp's gradient drops their
    cotangent (-inf lies below the clamp)."""
    from repro_torch.kernels import ops as kops

    if impl == "flash":
        if tables is None:
            raise ValueError("flash CP attention needs host visit tables")
        o, lse = kops.doc_flash_attention(
            q, k, v, q_doc, q_pos, kv_doc, kv_pos, tables, scale=scale,
            block_q=block_q, block_k=block_k, grid=grid, partial=True)
        m = torch.clamp(lse, min=NEG)
        return o.float(), m, torch.ones_like(m)
    return kops.doc_attention_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                                    scale=scale, q_chunk=q_chunk,
                                    partial=True)


def _masked_attention(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *, impl,
                      q_chunk, tables=None, block_q=128, block_k=128,
                      grid="rect"):
    """Normalized attention over one KV set, on either kernel."""
    from repro_torch.kernels import ops as kops

    if impl == "flash":
        if tables is None:
            raise ValueError("flash CP attention needs host visit tables")
        return kops.doc_flash_attention(q, k, v, q_doc, q_pos, kv_doc,
                                        kv_pos, tables, block_q=block_q,
                                        block_k=block_k, grid=grid)
    return kops.doc_attention_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                                    q_chunk=q_chunk)


def make_cp_context(plan_arrays: dict[str, Any], *,
                    strategy: str = "flashcp", impl: str = "plain",
                    head_dim: int, q_chunk: int = 512,
                    overlap: str = "chunked", block_q: int = 128,
                    block_k: int = 128, grid: str = "rect") -> ExecContext:
    """The ExecContext of a training step.

    ``plan_arrays`` hold the batch's plan-order ``doc``/``pos`` (B, C), the
    Eq.-5 send indices ``send_idx`` (B, N, buf) whose N is the CP size
    (absent: one rank), and, for ``impl="flash"``, the per-rank visit
    tables of ``grid`` (``tab_loc_*``/``tab_hop_*`` keys from
    :func:`repro_torch.planner.encode.emit_visit_tables`).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown CP strategy {strategy!r}; have "
                         f"{list(STRATEGIES)}")
    if impl not in ("flash", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}; use 'flash' or "
                         "'plain'")
    if grid not in ("rect", "flat"):
        raise ValueError(f"unknown kernel grid {grid!r}")
    overlap = resolve_overlap(strategy, impl, overlap)
    cp_size = plan_arrays["send_idx"].shape[1] \
        if "send_idx" in plan_arrays else 1
    if cp_size != 1:
        raise NotImplementedError(f"CP size {cp_size}: {_CP_SLICE}")
    if overlap != "chunked":
        raise NotImplementedError(
            f"overlap={overlap!r}: the monolithic islands come with {_CP_SLICE}")
    doc, pos = plan_arrays["doc"], plan_arrays["pos"]
    loc = None
    if impl == "flash":
        keys = table_keys("tab_loc_", grid)
        if not all(k in plan_arrays for k in keys):
            raise ValueError(
                f"flash attention with overlap='chunked' needs per-rank "
                f"local grid={grid!r} visit tables (tab_loc_* plan arrays; "
                "see repro_torch.planner.encode.emit_visit_tables)")
        # strip the rank dim of the (B, N=1, ...) per-rank tables
        loc = tuple(plan_arrays[k][:, 0].contiguous() for k in keys)

    attend = functools.partial(
        _partial_masked_attention, impl=impl, scale=head_dim ** -0.5,
        q_chunk=q_chunk, block_q=block_q, block_k=block_k, grid=grid)

    def attn(q, k, v):
        # the local-KV partial; at N = 1 no hop follows
        part = attend(q, k, v, doc, pos, doc, pos, tables=loc)
        return finalize_partial(part, q.dtype)

    return ExecContext(doc=doc, pos=pos, attn=attn)
