"""The plain reference of a dense decoder with grouped-query attention,
rotary positions and a plain gelu MLP (StarCoder2 as the port runs it:
RMS norms without biases, no sliding window, no dropout), with the
output head its own matrix or the embedding table itself (tied), in
plain PyTorch.  It imports nothing of the port.

The leaves are named by the port's parameter paths, so that the
benchmark can hand one set of weights to both sides; each per-layer
leaf is stacked on a leading layer axis, as the port stacks it.  Every
layer is one call of :func:`layer`, which ``reference.py`` runs once
without gradients and again, rematerialized, in the backward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["PORT_MODEL", "check_config", "leaf_specs", "layer", "embed",
           "final_norm", "head", "head_leaves", "HEAD", "EMBED"]

#: the port's ModelConfig fields beyond the sizes
PORT_MODEL = {"family": "dense", "mlp": "gelu"}

#: the settings this reference computes; a configuration that asks for
#: another is refused
_RUNS = {"model_type": "starcoder2", "norm_type": "rms_norm",
         "use_bias": False, "sliding_window": None,
         "hidden_act": "gelu_pytorch_tanh",
         "attention_dropout": 0.0, "residual_dropout": 0.0,
         "embedding_dropout": 0.0}

EMBED = "embed/e"
HEAD = "lm_head/w"
FINAL_NORM = "final_norm/g"
_L = "layers/sub_0/"


def check_config(name: str, cfg: dict) -> None:
    for key, want in _RUNS.items():
        if cfg.get(key) != want:
            raise ValueError(f"config {name}: {key}={cfg.get(key)!r}; the "
                             f"dense_decoder reference runs {key}={want!r}")


def leaf_specs(spec) -> list[tuple[str, tuple, tuple]]:
    """``(path, shape, init)`` of every leaf, in the order the weights
    are drawn; init is ``("normal", std)`` or ``("ones",)``.  Matrices
    are He-normal (std sqrt(1 / fan_in)), the embedding std 0.02, norm
    gains 1: the port's own initialization.  A tied head has no leaf of
    its own."""
    L, d, ff = spec.layers, spec.d_model, spec.d_ff
    q, kv = spec.heads * spec.head_dim, spec.kv_heads * spec.head_dim

    def he(fan_in):
        return ("normal", math.sqrt(1.0 / fan_in))

    leaves = [
        (EMBED, (spec.vocab, d), ("normal", 0.02)),
        (_L + "attn/wq", (L, d, q), he(d)),
        (_L + "attn/wk", (L, d, kv), he(d)),
        (_L + "attn/wv", (L, d, kv), he(d)),
        (_L + "attn/wo", (L, q, d), he(q)),
        (_L + "mlp/wi", (L, d, ff), he(d)),
        (_L + "mlp/wo", (L, ff, d), he(ff)),
        (_L + "norm1/g", (L, d), ("ones",)),
        (_L + "norm2/g", (L, d), ("ones",)),
        (FINAL_NORM, (d,), ("ones",)),
    ]
    if not spec.tie:
        leaves.append((HEAD, (d, spec.vocab), he(d)))
    return leaves


def layer_leaves(spec) -> list[str]:
    """The stacked per-layer leaves."""
    return [p for p, shape, _ in leaf_specs(spec) if p.startswith(_L)]


def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(x, pos, theta):
    """Half-split rotary embedding.  x (T, H, D); pos (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed(w, tokens):
    return w[EMBED][tokens]


def final_norm(w, x, spec):
    return rmsnorm(x, w[FINAL_NORM], spec.norm_eps)


def head_leaves(spec) -> tuple[str, str]:
    """The leaves the head reads: the final norm and its matrix."""
    return FINAL_NORM, EMBED if spec.tie else HEAD


def head(w, spec):
    """The head's (d, vocab) matrix: the embedding table's transpose
    where the head is tied."""
    return w[EMBED].T if spec.tie else w[HEAD]


def layer(w: dict, x, pos, docs, spec, mm, attention):
    """One decoder layer on one packed row.  ``w`` holds this layer's
    leaves (their slices of the stacked ones, by path), x (T, d), pos
    (T,) the positions inside each document, ``docs`` the documents'
    (start, end) token ranges; ``mm`` is the matrix product and
    ``attention(q, k, v, docs)`` the document-causal attention."""
    T = x.shape[0]
    hd = spec.head_dim
    h = rmsnorm(x, w[_L + "norm1/g"], spec.norm_eps)
    q = mm(h, w[_L + "attn/wq"]).reshape(T, spec.heads, hd)
    k = mm(h, w[_L + "attn/wk"]).reshape(T, spec.kv_heads, hd)
    v = mm(h, w[_L + "attn/wv"]).reshape(T, spec.kv_heads, hd)
    q, k = rope(q, pos, spec.rope_theta), rope(k, pos, spec.rope_theta)
    o = attention(q, k, v, docs).reshape(T, spec.heads * hd)
    x = x + mm(o, w[_L + "attn/wo"])
    h = rmsnorm(x, w[_L + "norm2/g"], spec.norm_eps)
    f = F.gelu(mm(h, w[_L + "mlp/wi"]), approximate="tanh")
    return x + mm(f, w[_L + "mlp/wo"])
