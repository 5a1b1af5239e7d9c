"""Plain PyTorch oracle for document-masked causal attention.

The semantic definition of attention in the port, and the prefill
attention of the serving path (as the JAX package leaves prefill
attention to its XLA oracle):

    token q may attend to token k   iff   doc(q) == doc(k)
                                      and pos(q) >= pos(k)
                                      and doc(q) >= 0 and doc(k) >= 0

Shapes (GQA): q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D), Hq % Hkv == 0.
"""

from __future__ import annotations

import torch

__all__ = ["doc_mask", "mha_reference"]


def doc_mask(q_doc, q_pos, kv_doc, kv_pos) -> torch.Tensor:
    """Boolean visibility mask of shape (..., Tq, Tk)."""
    same_doc = q_doc[..., :, None] == kv_doc[..., None, :]
    causal = q_pos[..., :, None] >= kv_pos[..., None, :]
    valid = (q_doc[..., :, None] >= 0) & (kv_doc[..., None, :] >= 0)
    return same_doc & causal & valid


def mha_reference(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *,
                  scale: float | None = None):
    """Dense reference attention: fp32 softmax, output in q's dtype.
    Rows with no visible key output zeros."""
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5

    qf = q.float().reshape(B, Hkv, G, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = doc_mask(q_doc, q_pos, kv_doc, kv_pos)        # (B, Tq, Tk)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))

    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = torch.where(l > 0, out / torch.clamp(l, min=1e-30),
                      torch.zeros_like(out))
    return out.reshape(B, Hq, Tq, D).to(q.dtype)
