"""AdamW with fp32 optimizer state mirroring the parameter tree.

When the parameters are stored in a reduced dtype (bf16 model weights)
the state carries an fp32 master copy; fp32 parameters are their own
master.  Unlike the reference, which builds a new tree, the update runs
in place — mu, nu and the master in their own storage, the parameters
overwritten from the master — one leaf slice at a time, so a full-width
model never holds more than a slice's worth of f32 temporaries.
"""

from __future__ import annotations

import torch

from ._slices import leaves, slices

__all__ = ["adamw_init", "adamw_update"]


def _zeros_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_f32(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _master(tree):
    if isinstance(tree, dict):
        return {k: _master(v) for k, v in tree.items()}
    return tree.detach().float().clone()


def adamw_init(params, *, keep_master: bool | None = None) -> dict:
    """Optimizer state: f32 ``mu``, ``nu``, an int32 ``count``, and an f32
    ``master`` when any parameter is stored below f32."""
    if keep_master is None:
        keep_master = any(p.dtype != torch.float32 for p in leaves(params))
    dev = leaves(params)[0].device
    state = {"mu": _zeros_f32(params), "nu": _zeros_f32(params),
             "count": torch.zeros((), dtype=torch.int32, device=dev)}
    if keep_master:
        state["master"] = _master(params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step in place; returns (params, state).  ``lr`` may be a
    0-d f32 tensor (a schedule value)."""
    state["count"] += 1
    c = state["count"].float()
    dev = c.device
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** c
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** c
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    ps, gs = leaves(params), leaves(grads)
    mus, nus = leaves(state["mu"]), leaves(state["nu"])
    has_master = "master" in state
    ms = leaves(state["master"]) if has_master else ps
    for leaf in zip(ps, gs, mus, nus, ms):
        for p, g, mu, nu, m in slices(*leaf):
            g = g.float()
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            step = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(eps))
            step.add_(m, alpha=weight_decay)
            m.sub_(step.mul_(lr))
            if has_master:
                p.copy_(m)
    return params, state
