"""Execution context: the seam between model code and the attention
runtime (the port of the reference's ``repro.models.context``).

Model code is written against :class:`ExecContext` and never mentions
tables or ranks.  ``doc``/``pos`` are per-token metadata in plan order;
``attn(q, k, v)`` maps q (B, Hq, T, D) and k, v (B, Hkv, T, D) to
(B, Hq, T, D).  ``extras`` carries the MoE hooks of a CP context
(``ep_dispatch``, the expert-parallel all-to-all island, and
``token_sum``, a differentiable sum over the ranks that hold the batch's
other tokens); a local context has none.  The SSM scans of the
reference's context wait for the recurrent families.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["ExecContext", "make_local_context"]


@dataclasses.dataclass
class ExecContext:
    doc: torch.Tensor
    pos: torch.Tensor
    attn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)


def make_local_context(doc: torch.Tensor, pos: torch.Tensor,
                       attention_impl: str = "plain", q_chunk: int = 512,
                       grid: str = "flat") -> ExecContext:
    """Single-device context: full-sequence doc-masked attention.

    ``attention_impl="flash"`` runs the training kernels on visit tables
    built from (doc, pos) once, on first use; ``"plain"`` the chunked
    dense attention."""
    from repro_torch.kernels import ops as kops

    if attention_impl not in ("flash", "plain"):
        raise ValueError(f"unknown attention impl {attention_impl!r}")
    tabs_cache: list = []   # the tables depend only on (doc, pos)

    def attn(q, k, v):
        if attention_impl == "flash":
            if not tabs_cache:
                from repro_torch.kernels.doc_attention import \
                    build_block_tables
                d, p = doc.cpu().numpy(), pos.cpu().numpy()
                tabs_cache.append(build_block_tables(d, p, d, p))
            return kops.doc_flash_attention(q, k, v, doc, pos, doc, pos,
                                            tabs_cache[0], grid=grid)
        return kops.doc_attention_plain(q, k, v, doc, pos, doc, pos,
                                        q_chunk=q_chunk)

    return ExecContext(doc=doc, pos=pos, attn=attn)
