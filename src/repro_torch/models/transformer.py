"""Decoder stacks of the dense, MoE, hybrid (Jamba), SSM (xLSTM), audio
(musicgen) and VLM (internvl) families: init, the training forward and losses, and for serving the
caches, chunked prefill and decode.

The parameter tree mirrors the JAX package's leaf for leaf: every
per-layer leaf is stacked on a leading period axis under
``layers.sub_j`` (a dense attention stack has period 1, Jamba's 7
Mamba + 1 attention layers period 8, xLSTM's 3 mLSTM + 1 sLSTM period
4), beside
``final_norm``, ``embed`` and ``lm_head``.  Where the reference scans
over periods, this loops over them in Python and hands each layer views
of its parameter and cache slices, so cache writes land in place in the
stacked tensors.

Training unbinds the stacked leaves once per forward, so each layer's
gradient lands in one stacked gradient per leaf, and rematerializes each
sublayer in the backward (``torch.utils.checkpoint`` without reentry, as
the reference wraps each sublayer in ``jax.checkpoint``).

MoE stacks (``num_experts > 0``) put a :func:`~.moe.moe_apply` FFN on
every ``moe_every``-th layer of a period; the training forward sums its
aux loss over the layers, and the losses add ``AUX_LOSS_WEIGHT`` times
it.  Serving routes prefill chunks drop-free and decode at the config's
capacity factor, as the reference does.

Recurrent mixers (Mamba, mLSTM, sLSTM) keep a dense per-slot scan state
in the decode cache instead of KV by position, so those stacks have no
cache-writing prefill and no paged layout
(:func:`supports_cached_prefill`, :func:`supports_paged_cache`): the
serving engine replays their prompts through :func:`decode_step`.

The audio and VLM stacks are attention stacks whose inputs carry
precomputed embeddings (:func:`inputs_to_embeds`): the audio family
reads ``frame_embeds`` in place of token ids (it has no embedding table
and always its own lm_head), the VLM family puts ``patch_embeds`` in
place of the token embeddings where ``patch_mask`` is set.  Each is per
token, so under CP it travels in plan order like ``tokens``.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from .attention import (attn_apply, attn_cache_init, attn_decode, attn_decode_paged,
                        attn_paged_cache_init, attn_prefill,
                        attn_prefill_paged)
from .layers import (EMBED_STD, chunked_lm_loss, cross_entropy, dense, embed,
                     he_normal, mlp_apply, rmsnorm)
from .moe import moe_apply, moe_init
from .ssm import mamba_apply, mamba_cache_init, mamba_decode, mamba_init
from .xlstm import (mlstm_apply, mlstm_cache_init, mlstm_decode, mlstm_init,
                    slstm_apply, slstm_cache_init, slstm_decode, slstm_init)

__all__ = ["period_length", "block_kinds", "init_params", "init_cache",
           "init_paged_cache", "inputs_to_embeds", "forward", "loss_fn",
           "loss_fn_chunked_head", "prefill_forward", "decode_step",
           "torch_dtype", "drop_free_capacity", "supports_cached_prefill",
           "supports_paged_cache", "AUX_LOSS_WEIGHT"]

AUX_LOSS_WEIGHT = 0.01


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def period_length(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return max(cfg.slstm_every, 1)
    if cfg.attn_every > 0:
        return math.lcm(cfg.attn_every, cfg.moe_every)
    return cfg.moe_every if cfg.num_experts > 0 else 1


def block_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds for one period: mixer "attn",
    "mamba", "mlstm" or "slstm"; ffn "dense", "moe" or "none"."""
    kinds = []
    for j in range(period_length(cfg)):
        if cfg.family == "ssm":
            mixer = "slstm" if j % cfg.slstm_every == cfg.slstm_every - 1 \
                else "mlstm"
        elif cfg.attn_every > 0:
            mixer = "attn" if j % cfg.attn_every == cfg.attn_offset \
                else "mamba"
        else:
            mixer = "attn"
        if cfg.d_ff == 0:
            ffn = "none"
        elif cfg.num_experts > 0 and j % cfg.moe_every == cfg.moe_every - 1:
            ffn = "moe"
        else:
            ffn = "dense"
        kinds.append((mixer, ffn))
    return kinds


def supports_cached_prefill(cfg: ModelConfig) -> bool:
    """Cache-writing prefill needs every mixer to be attention (KV caches
    are written by position); the recurrent stacks replay their
    prompts through :func:`decode_step`."""
    return all(mixer == "attn" for mixer, _ in block_kinds(cfg))


def supports_paged_cache(cfg: ModelConfig) -> bool:
    """Paged KV needs position-addressed caches in every mixer: a
    recurrent mixer's per-slot scan state has no block structure, so
    those stacks keep the dense slot-stripe layout."""
    return supports_cached_prefill(cfg)


def drop_free_capacity(cfg: ModelConfig) -> float:
    """The capacity factor at which no routing can clip (cap >= n needs
    cf >= E / top_k): serving prefill routes at it, as the reference
    does, so a prompt's KV does not depend on how it was chunked."""
    if not cfg.num_experts:
        return cfg.capacity_factor
    return max(cfg.capacity_factor,
               float(cfg.num_experts) / max(cfg.top_k, 1))


def _n_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers // period_length(cfg)


def _index(tree, i: int):
    """Period ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` periods of a stacked tree, one ``unbind`` per leaf: the
    backward stacks the per-period gradients once per leaf."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: str | torch.device = "cuda"):
    """Random parameters from a seeded ``torch.Generator``, made on
    ``device`` in the config's dtype: He-normal matrices (std
    sqrt(1/fan_in)), embeddings at std 0.02, norm gains at 1.  Each
    stacked leaf is drawn one layer at a time in fp32, so a full-width
    model never holds an fp32 copy."""
    dev = resolve_device(device)
    kinds = block_kinds(cfg)
    n_periods = _n_periods(cfg)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, hd, dff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    def stacked(shape, fan_in):
        out = torch.empty((n_periods, *shape), dtype=dtype, device=dev)
        for i in range(n_periods):
            out[i].copy_(he_normal(shape, fan_in, generator=gen, device=dev))
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def mixer_init(mixer):
        if mixer == "mamba":
            return mamba_init(stacked, d, periods=n_periods,
                              expand=cfg.mamba_expand,
                              d_state=cfg.mamba_d_state,
                              d_conv=cfg.mamba_d_conv, dtype=dtype,
                              device=dev)
        if mixer == "mlstm":
            return mlstm_init(stacked, d, hq, expand=cfg.mamba_expand)
        if mixer == "slstm":
            return slstm_init(stacked, d)
        attn = {"wq": stacked((d, hq * hd), d),
                "wk": stacked((d, hkv * hd), d),
                "wv": stacked((d, hkv * hd), d),
                "wo": stacked((hq * hd, d), hq * hd)}
        if cfg.qk_norm:
            attn["q_norm"] = ones(n_periods, hd)
            attn["k_norm"] = ones(n_periods, hd)
        return attn

    period = {}
    for j, (mixer, ffn) in enumerate(kinds):
        sub = {"norm1": {"g": ones(n_periods, d)}, mixer: mixer_init(mixer)}
        if ffn == "moe":
            sub["norm2"] = {"g": ones(n_periods, d)}
            sub["moe"] = moe_init(stacked, d, dff, cfg.num_experts,
                                  cfg.mlp)
        elif ffn != "none":
            mlp = {"wi": stacked((d, dff), d)}
            if cfg.mlp == "glu":
                mlp["wg"] = stacked((d, dff), d)
            mlp["wo"] = stacked((dff, d), dff)
            sub["norm2"] = {"g": ones(n_periods, d)}
            sub["mlp"] = mlp
        period[f"sub_{j}"] = sub

    params = {"layers": period, "final_norm": {"g": ones(d)}}
    if cfg.family != "audio":
        emb = torch.randn((cfg.vocab_size, d), generator=gen, device=dev,
                          dtype=torch.float32).mul_(EMBED_STD)
        params["embed"] = {"e": emb.to(dtype)}
    if not cfg.tie_embeddings or cfg.family == "audio":
        w = he_normal((d, cfg.vocab_size), d, generator=gen, device=dev)
        params["lm_head"] = {"w": w.to(dtype)}
    return params


def _sub_cache_init(cfg: ModelConfig, mixer: str, periods: int, batch: int,
                    max_len: int, dev):
    dtype = torch_dtype(cfg)
    if mixer == "attn":
        return attn_cache_init(cfg, periods, batch, max_len, dtype, dev)
    if mixer == "mamba":
        return mamba_cache_init(periods, batch, cfg.d_model,
                                expand=cfg.mamba_expand,
                                d_state=cfg.mamba_d_state,
                                d_conv=cfg.mamba_d_conv, dtype=dtype,
                                device=dev)
    if mixer == "mlstm":
        return mlstm_cache_init(periods, batch, cfg.d_model, cfg.num_heads,
                                expand=cfg.mamba_expand, device=dev)
    return slstm_cache_init(periods, batch, cfg.d_model, device=dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda"):
    """Dense per-slot caches, per sub-layer: KV stripes (P, B, Hkv, S, hd)
    for attention, the scan states for a recurrent mixer (Mamba: conv
    window (P, B, d_conv - 1, di) and SSM state (P, B, di, S) f32; mLSTM:
    C (P, B, H, dh, dh) and N (P, B, H, dh) f32; sLSTM: c (P, B, d)
    f32)."""
    dev, P = resolve_device(device), _n_periods(cfg)
    return {f"sub_{j}": _sub_cache_init(cfg, mixer, P, batch, max_len, dev)
            for j, (mixer, _) in enumerate(block_kinds(cfg))}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device: str | torch.device = "cuda"):
    """Global paged KV pool: per sub-layer (P, Hkv, num_blocks *
    block_size, hd), no slot axis.  Attention-only stacks
    (:func:`supports_paged_cache`)."""
    if not supports_paged_cache(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires attention-only "
                         "mixers")
    dev, P = resolve_device(device), _n_periods(cfg)
    return {f"sub_{j}": attn_paged_cache_init(cfg, P, num_blocks, block_size,
                                              torch_dtype(cfg), dev)
            for j in range(len(block_kinds(cfg)))}


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _head(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "lm_head" in params:
        return dense(params["lm_head"], x)
    return x @ params["embed"]["e"].to(x.dtype).T


def _ffn(sub, cfg: ModelConfig, ffn: str, x, ctx=None,
         capacity_factor: float | None = None):
    """x plus the sublayer's FFN; returns (x, aux), aux None unless the
    FFN is MoE.  x (B, T, d), or (B, d) for a decode step (its MoE then
    routes the B rows as B x 1 tokens, idle rows included)."""
    if ffn == "none":
        return x, None
    h = rmsnorm(sub["norm2"], x, cfg.norm_eps)
    if ffn != "moe":
        return x + mlp_apply(sub["mlp"], h, cfg.mlp), None
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    f, aux = moe_apply(sub["moe"], h if h.dim() == 3 else h[:, None], ctx,
                       top_k=cfg.top_k, capacity_factor=cf, kind=cfg.mlp)
    return x + f.reshape(x.shape), aux


def inputs_to_embeds(params, cfg: ModelConfig, batch):
    """The stack's input embeddings: the audio family's ``frame_embeds``
    (B, T, d) cast to the model dtype; else the token embeddings, with
    the VLM family's ``patch_embeds`` (B, T, d) where ``patch_mask`` (B,
    T) is set.  ``params`` needs ``embed`` only where tokens are read."""
    dtype = torch_dtype(cfg)
    if cfg.frontend == "audio_frames":
        return batch["frame_embeds"].to(dtype)
    x = embed(params["embed"], batch["tokens"], dtype)
    if cfg.frontend == "vit_patches":
        x = torch.where(batch["patch_mask"][..., None],
                        batch["patch_embeds"].to(dtype), x)
    return x


def _apply_sub(sub, cfg: ModelConfig, ctx, x, mixer: str, ffn: str):
    """One sublayer: (x, aux or None)."""
    h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
    if mixer == "attn":
        mx = attn_apply(sub["attn"], cfg, ctx, h)
    elif mixer == "mamba":
        mx = mamba_apply(sub["mamba"], h, ctx, d_state=cfg.mamba_d_state,
                         d_conv=cfg.mamba_d_conv)
    elif mixer == "mlstm":
        mx = mlstm_apply(sub["mlstm"], h, ctx, num_heads=cfg.num_heads)
    else:
        mx = slstm_apply(sub["slstm"], h, ctx)
    return _ffn(sub, cfg, ffn, x + mx, ctx)


def _whole(prefix: str, tree):
    """The ``gather`` hook of unsharded parameters: the tree itself."""
    return tree


def _trunk(params, cfg: ModelConfig, ctx, batch, remat: bool, gather):
    """Embeddings through every layer; returns (x, aux), aux the f32 sum
    of the MoE layers' aux losses (0 for a dense stack).  ``gather(prefix,
    tree)`` makes whole leaves of the parameters at ``prefix`` where they
    are used; a layer's runs inside its rematerialized function, so the
    backward gathers the layer again instead of keeping it."""
    kinds = block_kinds(cfg)
    x = inputs_to_embeds({k: gather(k, params[k]) for k in ("embed",)
                          if k in params}, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unbind(params["layers"], _n_periods(cfg)):
        for j, (mixer, ffn) in enumerate(kinds):
            def apply(sub, x, mixer=mixer, ffn=ffn, name=f"layers/sub_{j}"):
                return _apply_sub(gather(name, sub), cfg, ctx, x, mixer,
                                  ffn)
            sub = lp[f"sub_{j}"]
            x, a = checkpoint(apply, sub, x, use_reentrant=False) if remat \
                else apply(sub, x)
            if a is not None:
                aux = aux + a
    return x, aux


def _head_params(params, gather):
    """The leaves the head reads, whole."""
    out = {k: gather(k, params[k]) for k in ("final_norm", "lm_head")
           if k in params}
    if "lm_head" not in params:
        out["embed"] = gather("embed", params["embed"])
    return out


def forward(params, cfg: ModelConfig, ctx, batch, *, remat: bool = True,
            gather=_whole):
    """batch -> (logits (B, T, vocab), aux_loss scalar).

    Remat: the residual stream between sublayers is saved; each
    sublayer's interior is recomputed in the backward, so its attention
    forward runs twice per step.  ``gather``: the hook that makes
    sharded parameters whole where they are used (ZeRO-3)."""
    x, aux = _trunk(params, cfg, ctx, batch, remat, gather)
    return _head(_head_params(params, gather), cfg, x), aux


def loss_fn(params, cfg: ModelConfig, ctx, batch, *, remat: bool = True,
            gather=_whole):
    logits, aux = forward(params, cfg, ctx, batch, remat=remat,
                          gather=gather)
    ce = cross_entropy(logits, batch["labels"])
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def loss_fn_chunked_head(params, cfg: ModelConfig, ctx, batch, *,
                         remat: bool = True, chunk: int = 128):
    """Loss with the fused chunked head: the (B, T, vocab) logits are
    never materialized."""
    x, aux = _trunk(params, cfg, ctx, batch, remat, _whole)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["lm_head"]["w"] if "lm_head" in params \
        else params["embed"]["e"].T
    ce = chunked_lm_loss(x, head, batch["labels"], chunk=chunk)
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux}


def prefill_forward(params, cfg: ModelConfig, cache, batch, pos, active, *,
                    with_logits: bool = True, block_tables=None,
                    block_size: int = 0, view_blocks: int = 0):
    """Forward one prompt chunk and write its KV into ``cache`` in place.

    batch: the forward's inputs for a (B, T) chunk ("tokens", or the
    frontend keys of :func:`inputs_to_embeds`); pos (B, T) global cache
    positions; active
    (B, T) bool (False = padding: no cache write, no influence).
    ``block_tables`` (B, nk) selects the paged pool layout, attending
    the request's gathered logical prefix of ``view_blocks`` blocks.
    Returns (logits (B, T, vocab) or None when ``with_logits`` is False,
    cache).  MoE layers route drop-free (:func:`drop_free_capacity`).
    Attention-only stacks (:func:`supports_cached_prefill`)."""
    if not supports_cached_prefill(cfg):
        raise ValueError(f"{cfg.name}: cache-writing prefill requires "
                         "attention-only mixers")
    kinds = block_kinds(cfg)
    cf = drop_free_capacity(cfg)
    x = inputs_to_embeds(params, cfg, batch)
    write_idx = active.nonzero(as_tuple=True)
    for i in range(_n_periods(cfg)):
        lp, lc = _index(params["layers"], i), _index(cache, i)
        for j, (_, ffn) in enumerate(kinds):
            sub = lp[f"sub_{j}"]
            h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
            if block_tables is not None:
                mx, _ = attn_prefill_paged(
                    sub["attn"], cfg, h, pos, lc[f"sub_{j}"], active,
                    block_tables, block_size=block_size,
                    view_blocks=view_blocks, write_idx=write_idx)
            else:
                mx, _ = attn_prefill(sub["attn"], cfg, h, pos,
                                     lc[f"sub_{j}"], active,
                                     write_idx=write_idx)
            x, _ = _ffn(sub, cfg, ffn, x + mx, capacity_factor=cf)
    if not with_logits:
        return None, cache
    return _head(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, cache, batch, pos_t, *,
                attn_impl: str = "flash", attn_shards: int = 1,
                block_tables=None, block_size: int = 0, write_mask=None,
                gather=_whole, cache_comm=None):
    """One decode step.  batch {"tokens": (B,)}, or {"frame_embeds": (B,
    d)} for the audio family; pos_t (B,) int32 current positions.
    Returns (logits (B, vocab), cache), the cache updated in place.

    ``attn_impl`` "flash" runs the flash-decode kernels, "dense" the
    softmax oracle.  ``block_tables`` (B, nk) selects the paged pool.
    ``write_mask`` (B,) bool restricts cache writes to its rows (the
    paged layout also hides all KV from the other rows); None writes
    every row.  MoE layers route the B rows (idle ones too) at the
    config's capacity factor, as the reference's decode does.

    ``gather`` makes sharded parameters whole where they are used
    (ZeRO-3: one layer at a time); ``cache_comm`` splits the attention
    caches' S axis over its ranks (``attn_decode``'s ``comm``)."""
    kinds = block_kinds(cfg)
    if cfg.frontend == "audio_frames":
        x = batch["frame_embeds"].to(torch_dtype(cfg))
    else:
        x = embed(gather("embed", params["embed"]), batch["tokens"],
                  torch_dtype(cfg))
    if block_tables is not None and write_mask is None:
        write_mask = torch.ones(x.shape[0], dtype=torch.bool,
                                device=x.device)
    rows = None if write_mask is None else write_mask.nonzero().flatten()
    for i in range(_n_periods(cfg)):
        lp, lc = _index(params["layers"], i), _index(cache, i)
        for j, (mixer, ffn) in enumerate(kinds):
            sub = gather(f"layers/sub_{j}", lp[f"sub_{j}"])
            c = lc[f"sub_{j}"]
            h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
            if mixer != "attn":
                mx = _recurrent_decode(sub, cfg, mixer, h, c, rows)
            elif block_tables is not None:
                mx, _ = attn_decode_paged(
                    sub["attn"], cfg, h, pos_t, c, block_tables, write_mask,
                    impl=attn_impl, block_size=block_size, write_rows=rows)
            else:
                mx, _ = attn_decode(sub["attn"], cfg, h, pos_t, c,
                                    impl=attn_impl, shards=attn_shards,
                                    write_rows=rows, comm=cache_comm)
            x, _ = _ffn(sub, cfg, ffn, x + mx)
    return _head(_head_params(params, gather), cfg, x), cache


def _recurrent_decode(sub, cfg: ModelConfig, mixer: str, h, cache, rows):
    """One token through a recurrent mixer; its new states are written
    into ``cache`` (views of the stacked leaves) on ``rows`` (None: every
    row), as the reference masks the rows of its functional update."""
    if mixer == "mamba":
        mx, new = mamba_decode(sub["mamba"], h, cache,
                               d_state=cfg.mamba_d_state,
                               d_conv=cfg.mamba_d_conv)
    elif mixer == "mlstm":
        mx, new = mlstm_decode(sub["mlstm"], h, cache,
                               num_heads=cfg.num_heads)
    else:
        mx, new = slstm_decode(sub["slstm"], h, cache)
    for name, leaf in cache.items():
        if rows is None:
            leaf.copy_(new[name])
        else:
            leaf[rows] = new[name][rows].to(leaf.dtype)
    return mx
