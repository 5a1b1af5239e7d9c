"""The training step (the port of the reference's
``repro.launch.steps.build_train_step``).

One step is loss + gradients (autograd through the attention context and
the rematerialized layers), global-norm clipping, the warmup-cosine LR
and an in-place AdamW update.  ``accum > 1`` splits the batch into
micro-batches and token-weights their gradients, so the accumulated
update equals the fused one on the same batch (the global masked CE mean
is Σ ce_sum / Σ tokens either way).

Context parallelism over N ranks (``comm`` given): the parameters are
replicated over the CP group and every rank runs the model on its token
slice of the batch (the plan order puts worker j's tokens at ``[j t_loc,
(j+1) t_loc)``), its attention through the CP islands.  Each rank's loss
is its masked-CE sum over the *global* count of valid labels (a sum over
the group, without gradient), so the losses of the ranks add up to the
reference's global masked-CE mean; after the backward the gradients are
summed over the group, and clipping and AdamW then run on every rank
alike, keeping the replicas equal.  Sharding the parameters and the
optimizer state (ZeRO-3 / FSDP over a data axis) comes with a later
slice of the port.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.comm import CPComm, all_reduce_sum_
from repro_torch.core.cp_attention import make_cp_context
from repro_torch.data.pipeline import exec_style_of
from repro_torch.device import resolve_device
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import adamw_update, clip_by_global_norm, warmup_cosine
from repro_torch.optim._slices import leaves

__all__ = ["build_train_step", "batch_to_device"]


def batch_to_device(batch: dict[str, Any], device) -> dict[str, Any]:
    """The pipeline's numpy batch as tensors on ``device`` (``perm`` and
    ``stats`` are host-side and dropped)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items() if k not in ("stats", "perm")}


def _plan_keys(batch):
    return {k: batch[k] for k in batch
            if k in ("doc", "pos", "send_idx", "gath_doc", "gath_pos")
            or k.startswith("tab_")}


def _unflatten(like, flat):
    """Rebuild the nested-dict shape of ``like`` from sorted-key leaves."""
    it = iter(flat)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        return next(it)

    return go(like)


def _rank_slice(batch, comm: CPComm | None):
    """This rank's token slice of the batch's tokens and labels."""
    if comm is None:
        return batch
    t_loc = batch["labels"].shape[1] // comm.size
    my = slice(comm.rank * t_loc, (comm.rank + 1) * t_loc)
    return {k: batch[k][:, my] for k in ("tokens", "labels")}


def build_train_step(cfg: ModelConfig, run: RunConfig, *, q_chunk: int = 512,
                     block_q: int = 128, block_k: int = 128, accum: int = 1,
                     device="cuda", comm: CPComm | None = None):
    """A callable ``train_step(params, opt_state, batch, step)`` that
    updates ``params`` and ``opt_state`` in place and returns the metrics
    dict (loss, ce, aux, grad_norm, lr, tokens) as 0-d tensors.

    ``batch`` is a dict of tensors on ``device`` (:func:`batch_to_device`),
    the whole batch on every rank; with ``attention_impl="flash"`` it
    carries the visit tables.  ``comm`` is this rank's CP group when the
    batch was planned for N > 1 ranks.  The callable also exposes
    ``loss_and_grads(params, batch)``.
    """
    resolve_device(device)
    if run.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={run.grad_compression!r}: gradient "
            "compression comes with the distributed slice of the port")
    exec_strategy = exec_style_of(run.cp_strategy)

    def _ctx_of(batch):
        return make_cp_context(
            _plan_keys(batch), strategy=exec_strategy,
            impl=run.attention_impl, head_dim=cfg.resolved_head_dim,
            q_chunk=q_chunk, overlap=run.cp_overlap, block_q=block_q,
            block_k=block_k, grid=run.kernel_grid, comm=comm)

    def loss_and_grads(params, batch):
        """((loss, metrics), grads) of the global masked CE mean."""
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        local = _rank_slice(batch, comm)
        loss, metrics = loss_fn(params, cfg, _ctx_of(batch), local,
                                remat=run.remat)
        if comm is not None:
            # local mean -> local sum over the global token count
            n_loc = torch.sum(local["labels"] >= 0).float()
            n_glob = n_loc.clone()
            all_reduce_sum_([n_glob], comm)
            weight = n_loc / torch.clamp(n_glob, min=1.0)
            loss = loss * weight
            metrics = {k: v * weight for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, flat)
        loss = loss.detach()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if comm is not None:
            loss = loss.clone()
            all_reduce_sum_([loss, *metrics.values(), *grads], comm)
        return (loss, metrics), _unflatten(params, grads)

    def _micro(batch, m):
        """Micro-batch m: rows [m B/accum, (m+1) B/accum)."""
        def sl(v):
            n = v.shape[0] // accum
            return v[m * n:(m + 1) * n]
        return {k: sl(v) for k, v in batch.items()}

    def train_step(params, opt_state, batch, step):
        if accum == 1:
            (loss, metrics), grads = loss_and_grads(params, batch)
        else:
            B = batch["labels"].shape[0]
            if B % accum:
                raise ValueError(f"accum {accum} does not divide batch {B}")
            g_sum = metr_sum = None
            loss_sum = tok_sum = 0.0
            for m in range(accum):
                mb = _micro(batch, m)
                (l_m, metr_m), g_m = loss_and_grads(params, mb)
                tok = torch.sum(mb["labels"] >= 0).float()
                g_m = [g.float() * tok for g in leaves(g_m)]
                g_sum = g_m if g_sum is None else \
                    [a.add_(b) for a, b in zip(g_sum, g_m)]
                metr_m = {k: v * tok for k, v in metr_m.items()}
                metr_sum = metr_m if metr_sum is None else \
                    {k: metr_sum[k] + metr_m[k] for k in metr_sum}
                loss_sum = loss_sum + l_m * tok
                tok_sum = tok_sum + tok
            denom = torch.clamp(tok_sum, min=1.0)
            grads = _unflatten(params, [g.div_(denom) for g in g_sum])
            metrics = {k: v / denom for k, v in metr_sum.items()}
            loss = loss_sum / denom
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = warmup_cosine(step, base_lr=run.lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=run.total_steps)
        adamw_update(params, grads, opt_state, lr=lr,
                     weight_decay=run.weight_decay)
        return {"loss": loss, "grad_norm": gnorm, "lr": lr,
                "tokens": torch.sum(batch["labels"] >= 0), **metrics}

    train_step.loss_and_grads = loss_and_grads
    return train_step
