"""Mixture-of-Experts FFN (the port of the reference's
``repro.models.moe``).

Routing (top-k, gates, aux loss) runs over the rank's tokens; dispatch and
combine run through ``ctx.extras["ep_dispatch"]`` where the context has
one:

* local (no context, or one without ``ep_dispatch``): sort-based
  capacity-clipped dispatch on this process's tokens (Megablocks-style
  gather/scatter), the expert FFNs as batched products, the weighted
  combine;
* CP context (:mod:`repro_torch.core.cp_attention`): the same dispatch
  per rank, followed by an all-to-all over the ``model`` axis, which
  holds the experts split among its ranks (:func:`repro_torch.core.comm.
  all_to_all_tiled`).

Aux load-balancing loss: the switch-transformer loss ``E * Σ_e f_e ·
p_e`` (f = routed gate fraction, from an f32 scatter-add of the gates;
p = mean router probability).  Where the context has a ``token_sum``
hook (a differentiable sum over every rank that holds other tokens of
the batch), f and p are those of the whole batch, as in the reference's
global view.

The reference computes all of this outside any Pallas kernel (XLA gather,
scatter and einsum), so the port's products are plain ``torch.bmm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_init", "moe_apply", "dispatch_local", "expert_ffn",
           "combine_local", "capacity", "local_ep_dispatch"]


def moe_init(make, d: int, d_ff: int, num_experts: int, kind: str) -> dict:
    """The ``moe`` sub-tree: ``make(shape, fan_in)`` draws one He-normal
    leaf (stacked over the periods by the caller)."""
    p = {"router": make((d, num_experts), d),
         "wi": make((num_experts, d, d_ff), d),
         "wo": make((num_experts, d_ff, d), d_ff)}
    if kind == "glu":
        p["wg"] = make((num_experts, d, d_ff), d)
    return p


def capacity(n_tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: ceil(top_k n cf / E), at least 1."""
    return int(max(1, -(-top_k * n_tokens * capacity_factor //
                        num_experts)))


# --------------------------------------------------------------------- #
# dispatch / combine primitives (one rank's tokens)
# --------------------------------------------------------------------- #
def dispatch_local(xt, topi, gates, num_experts: int, cap: int):
    """xt (n, d); topi/gates (n, K) -> (buf (E, cap, d), slot, tok_s,
    gat_s, keep) for :func:`combine_local`.

    The (token, choice) pairs are sorted by expert with a *stable* sort,
    so within an expert the lower token index keeps its slot first, as
    the reference's ``argsort(stable=True)`` does; pairs past ``cap``
    land in a dump row that is cut off."""
    n, d = xt.shape
    K = topi.shape[-1]
    E = num_experts
    dev = xt.device
    eid = topi.reshape(-1).long()
    tok = torch.arange(n, device=dev).repeat_interleave(K)
    gat = gates.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    eid_s, tok_s, gat_s = eid[order], tok[order], gat[order]
    counts = torch.bincount(eid_s, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * K, device=dev) - starts[eid_s]
    keep = pos_in_e < cap
    slot = torch.where(keep, eid_s * cap + pos_in_e,
                       torch.full_like(eid_s, E * cap))
    buf = xt.new_zeros((E * cap + 1, d)).index_copy(0, slot, xt[tok_s])
    return buf[:E * cap].reshape(E, cap, d), slot, tok_s, gat_s, keep


def expert_ffn(buf, wi, wg, wo, kind: str):
    """buf (E_local, C, d) with per-expert weights (E_local, d, f)."""
    h = torch.bmm(buf, wi.to(buf.dtype))
    if kind == "glu":
        h = F.silu(torch.bmm(buf, wg.to(buf.dtype))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo.to(buf.dtype))


def combine_local(y, slot, tok_s, gat_s, keep, n: int):
    """y (E, cap, d) -> (n, d): each token's kept expert outputs, gate
    weighted, summed in y's dtype."""
    E, cap, d = y.shape
    yf = torch.cat([y.reshape(E * cap, d), y.new_zeros((1, d))], 0)
    contrib = yf[slot] * (gat_s * keep).to(y.dtype)[:, None]
    return y.new_zeros((n, d)).index_add(0, tok_s, contrib)


def local_ep_dispatch(x, topi, gates, params, *, kind: str,
                      capacity_factor: float):
    """Single-rank dispatch (no expert parallelism), capacity from this
    call's B * T tokens."""
    B, T, d = x.shape
    E = params["wi"].shape[0]
    K = topi.shape[-1]
    n = B * T
    cap = capacity(n, E, K, capacity_factor)
    buf, slot, tok_s, gat_s, keep = dispatch_local(
        x.reshape(n, d), topi.reshape(n, K), gates.reshape(n, K), E, cap)
    y = expert_ffn(buf, params["wi"], params.get("wg"), params["wo"], kind)
    return combine_local(y, slot, tok_s, gat_s, keep, n).reshape(B, T, d)


# --------------------------------------------------------------------- #
def moe_apply(p, x, ctx, *, top_k: int, capacity_factor: float, kind: str):
    """x (B, T, d) -> (out (B, T, d), aux_loss f32 scalar)."""
    B, T, _ = x.shape
    E = p["router"].shape[-1]
    extras = {} if ctx is None else ctx.extras

    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)             # (B, T, K)
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    f_sum = torch.zeros((E,), dtype=torch.float32,
                        device=x.device).index_add(0, topi.reshape(-1),
                                                   gates.reshape(-1))
    p_sum = probs.sum((0, 1))
    n = torch.full((1,), float(B * T), dtype=torch.float32, device=x.device)
    token_sum = extras.get("token_sum")
    if token_sum is not None:       # the whole batch's statistics
        f_sum, p_sum, n = token_sum(f_sum), token_sum(p_sum), token_sum(n)
    aux = E * torch.sum((f_sum / n) * (p_sum / n))

    ep = extras.get("ep_dispatch")
    if ep is None:
        out = local_ep_dispatch(x, topi, gates, p, kind=kind,
                                capacity_factor=capacity_factor)
    else:
        out = ep(x, topi, gates, p, kind=kind,
                 capacity_factor=capacity_factor)
    return out.to(x.dtype), aux
