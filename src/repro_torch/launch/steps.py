"""The training step (the port of the reference's
``repro.launch.steps.build_train_step``) and the strategy a model family
trains on (:func:`effective_strategy`).

One step is loss + gradients (autograd through the attention context and
the rematerialized layers), global-norm clipping, optional gradient
compression, the warmup-cosine LR and an in-place AdamW update.
``accum > 1`` splits the batch into micro-batches and token-weights
their gradients, so the accumulated update equals the fused one on the
same batch (the global masked CE mean is Σ ce_sum / Σ tokens either
way).

On a mesh of more than one rank (``data x model``, or ``pod x data x
model``; ``zero`` given, a :class:`~repro_torch.runtime.zero.Zero3`),
the parameters and the optimizer state are this rank's ZeRO-3 shards,
gathered layer by layer where they are used.  Every rank takes its rows
of the batch (by its ``pod`` and ``data`` indices, as
:func:`~repro_torch.runtime.sharding.batch_specs` splits them) and its
token slice (by its ``model`` index; the plan
order puts CP worker j's tokens at ``[j t_loc, (j+1) t_loc)``), and runs
its attention through the CP islands of its ``model`` row.  Each rank's
loss is its masked-CE sum over the *world's* count of valid labels, so
the losses of the ranks add up to the reference's global masked-CE mean
and the gradients reaching each shard (summed by the gathers' reduce-
scatters and, over the axes a leaf is whole on, by an all-reduce) are
its gradient.  Rows that do not divide by the batch axes go to every
rank of them, as the reference replicates them; the world's label count
then counts them once per batch rank, which weights each copy by 1/D (D
the product of the batch axes).
Clipping and compression take their statistics over every rank's
shards.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.comm import all_reduce_
from repro_torch.core.cp_attention import make_cp_context
from repro_torch.data.pipeline import exec_style_of
from repro_torch.device import resolve_device
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               compress_tree, warmup_cosine)
from repro_torch.optim._slices import leaves
from repro_torch.planner.registry import RECURRENT_FAMILIES, get_planner
from repro_torch.runtime.sharding import (batch_axes_of, batch_specs,
                                          take_shard)

__all__ = ["build_train_step", "batch_to_device", "rank_batch",
           "effective_strategy", "frontend_keys"]


def effective_strategy(cfg: ModelConfig, requested: str) -> str:
    """The planner a model family trains on.  Recurrent families (Jamba,
    xLSTM) carry scan state from rank to rank in token order, so a
    planner that does not preserve it (``PlannerInfo.
    preserves_token_order``) is swapped for ``contiguous`` (its
    sharding-aware communication still applies).  Unknown names raise,
    listing the registered planners."""
    keeps = get_planner(requested).info.preserves_token_order
    if cfg.family in RECURRENT_FAMILIES and not keeps:
        return "contiguous"
    return requested


def batch_to_device(batch: dict[str, Any], device) -> dict[str, Any]:
    """The pipeline's numpy batch as tensors on ``device`` (``perm`` and
    ``stats`` are host-side and dropped)."""
    dev = resolve_device(device)
    with obs.span("batch_to_device"):
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


#: the keys whose token columns a rank takes itself (the plan keys stay
#: whole: the CP context takes this rank's slices of them)
MODEL_INPUTS = ("tokens", "labels", "frame_embeds", "patch_embeds",
                "patch_mask")


def frontend_keys(cfg: ModelConfig) -> tuple[str, ...]:
    """The per-token embedding keys the family's training batch carries
    (as the reference's input specs name them): none for the token
    families."""
    return {"audio_frames": ("frame_embeds",),
            "vit_patches": ("patch_embeds", "patch_mask")}.get(
                cfg.frontend, ())


def rank_batch(batch, axes: dict, coords: dict) -> dict:
    """The rank at ``coords``'s part of the whole batch under
    :func:`~repro_torch.runtime.sharding.batch_specs`: its rows of every
    key, and its token columns of the model inputs (tokens, labels and
    the frontends' per-token keys).  The plan keys keep their token and
    rank axes whole: the CP context takes this rank's slices of them
    itself."""
    specs = batch_specs(axes, {k: tuple(v.shape) for k, v in batch.items()})
    out = {}
    for k, v in batch.items():
        spec = specs[k]
        if k not in MODEL_INPUTS:
            spec = spec[:1]
        out[k] = take_shard(v, spec, axes, coords)
    return out


def build_train_step(cfg: ModelConfig, run: RunConfig, *, q_chunk: int = 512,
                     block_q: int = 128, block_k: int = 128, accum: int = 1,
                     device="cuda", zero=None):
    """A callable ``train_step(params, opt_state, batch, step)`` that
    updates ``params`` and ``opt_state`` in place and returns the metrics
    dict (loss, ce, aux, grad_norm, lr, tokens) as 0-d tensors.

    ``batch`` is a dict of tensors on ``device`` (:func:`batch_to_device`),
    the whole batch on every rank; with ``attention_impl="flash"`` it
    carries the visit tables.  The audio and VLM families also need
    their frontend keys (:func:`frontend_keys`: ``frame_embeds`` (B, C,
    d), ``patch_embeds`` (B, C, d) and ``patch_mask`` (B, C)), per token
    in the batch's plan order like ``tokens``; the audio family's
    ``tokens`` are dropped (its inputs are the frames).

    ``zero`` is this rank's ZeRO-3 layout when the step runs on a mesh
    of more than one rank (the batch then planned for its ``model``
    axis); ``params`` and ``opt_state`` are then this rank's shards.  The callable also exposes
    ``loss_and_grads(params, batch)``, whose gradients are shards too,
    and ``apply_grads(params, opt_state, grads, step)``, the rest of the
    step.
    """
    cuda = resolve_device(device).type == "cuda"
    exec_strategy = exec_style_of(effective_strategy(cfg, run.cp_strategy))
    groups = 1 if zero is None else math.prod(
        zero.axes[a] for a in batch_axes_of(zero.axes))

    def _ctx_of(batch):
        return make_cp_context(
            _plan_keys(batch), strategy=exec_strategy,
            impl=run.attention_impl, head_dim=cfg.resolved_head_dim,
            q_chunk=q_chunk, overlap=run.cp_overlap, block_q=block_q,
            block_k=block_k, grid=run.kernel_grid,
            kv_comm_dtype=run.kv_comm_dtype,
            comm=None if zero is None else zero.cp,
            world=None if zero is None else zero.world)

    need = frontend_keys(cfg)

    def loss_and_grads(params, batch):
        """((loss, metrics), grads) of the global masked CE mean."""
        missing = [k for k in need if k not in batch]
        if missing:
            raise KeyError(f"{cfg.name} ({cfg.family}) trains on "
                           f"{', '.join(need)}: the batch lacks "
                           f"{', '.join(missing)}")
        if cfg.frontend == "audio_frames":
            batch = {k: v for k, v in batch.items() if k != "tokens"}
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        kw = {}
        if zero is not None:
            batch = rank_batch(batch, zero.axes, zero.coords)
            kw["gather"] = zero.gather
        with obs.span("step.forward", device=cuda):
            loss, metrics = loss_fn(params, cfg, _ctx_of(batch), batch,
                                    remat=run.remat, **kw)
        if zero is not None:
            # local mean -> local sum over the world's token count
            n_loc = torch.sum(batch["labels"] >= 0).float()
            n_glob = n_loc.clone()
            all_reduce_([n_glob], zero.world)
            weight = n_loc / torch.clamp(n_glob, min=1.0)
            loss = loss * weight
            metrics = {k: v * weight for k, v in metrics.items()}
        with obs.span("step.backward", device=cuda):
            grads = torch.autograd.grad(loss, flat)
        loss = loss.detach().clone()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if zero is not None:
            all_reduce_([loss, *metrics.values()], zero.world)
            zero.reduce_grads_(list(grads))
        return (loss, metrics), _unflatten(params, grads)

    def _micro(batch, m):
        """Micro-batch m: rows ``[g spg + m spg/accum, g spg + (m+1)
        spg/accum)`` of every batch group g (``spg`` its rows; the groups
        are the ranks of the batch axes), as the reference slices
        them."""
        def sl(v):
            n = v.shape[0] // (groups * accum)
            x = v.reshape((groups, accum, n) + v.shape[1:])
            return x[:, m].reshape((groups * n,) + v.shape[1:])
        return {k: sl(v) for k, v in batch.items()}

    def train_step(params, opt_state, batch, step):
        with obs.span("step", step=step, device=cuda):
            return _train_step(params, opt_state, batch, step)

    def _train_step(params, opt_state, batch, step):
        if accum == 1:
            (loss, metrics), grads = loss_and_grads(params, batch)
        else:
            B = batch["labels"].shape[0]
            if B % (groups * accum):
                raise ValueError(f"accum {accum} x {groups} data groups do "
                                 f"not divide batch {B}")
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
        gnorm, lr = apply_grads(params, opt_state, grads, step)
        return {"loss": loss, "grad_norm": gnorm, "lr": lr,
                "tokens": torch.sum(batch["labels"] >= 0), **metrics}

    def apply_grads(params, opt_state, grads, step):
        """The step's update from its gradients, in place: clip by the
        global norm (over every rank's shards), compress, the schedule's
        lr, AdamW.  Returns (grad norm before clipping, lr)."""
        with obs.span("step.optimizer", device=cuda):
            norm = None if zero is None else zero.global_norm(leaves(grads))
            grads, gnorm = clip_by_global_norm(grads, run.grad_clip,
                                               norm=norm)
            if run.grad_compression != "none":
                grads, _ = compress_tree(grads, None, run.grad_compression,
                                         layout=zero)
            lr = warmup_cosine(step, base_lr=run.lr,
                               warmup_steps=run.warmup_steps,
                               total_steps=run.total_steps)
            adamw_update(params, grads, opt_state, lr=lr,
                         weight_decay=run.weight_decay)
        return gnorm, lr

    train_step.loss_and_grads = loss_and_grads
    train_step.apply_grads = apply_grads
    return train_step
