"""Shared building blocks: plain functions over parameter dicts.

The same functional style as the JAX package: ``init_*`` builds nested
parameter dicts, apply functions take ``(params, x, ...)``.  Weights keep
the JAX matmul layout (``x @ w`` with w of shape (d_in, d_out)), so the
reference's parameters convert leaf for leaf.  Compute dtype follows the
input; parameters are cast at use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["he_normal", "dense", "rmsnorm", "embed", "rope", "mlp_apply",
           "cross_entropy", "chunked_lm_loss", "EMBED_STD"]

#: standard deviation of the embedding init
EMBED_STD = 0.02


def he_normal(shape, fan_in: int, *, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """fp32 normal with std sqrt(1 / fan_in) (the reference's ``_he``)."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.mul_(math.sqrt(1.0 / max(fan_in, 1)))


def dense(p, x):
    return x @ p["w"].to(x.dtype)


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * p["g"]).to(x.dtype)


def embed(p, tokens, dtype: torch.dtype):
    """Token embedding; negative (padding) tokens embed to zeros, and the
    mask keeps their gradient out of the table."""
    out = p["e"][tokens.clamp(min=0)].to(dtype)
    return torch.where((tokens >= 0)[..., None], out,
                       torch.zeros((), dtype=dtype, device=out.device))


def rope(x, pos, theta: float = 10_000.0):
    """Rotary embedding, half-split, angles in fp32.  x (B, H, T, D);
    pos (B, T) positions."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[:, None, :, None].float() * freqs          # (B, 1, T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mlp_apply(p, x, kind: str):
    """silu-GLU (llama family) or plain gelu MLP (starcoder2).  The gelu
    is the tanh approximation, as ``jax.nn.gelu`` defaults to."""
    if kind == "glu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    else:
        h = F.gelu(x @ p["wi"].to(x.dtype), approximate="tanh")
    return h @ p["wo"].to(x.dtype)


def cross_entropy(logits, labels):
    """Mean CE over valid positions (labels < 0 are masked).  logits
    (B, T, V); labels (B, T).  fp32 log-softmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def chunked_lm_loss(x, head_w, labels, *, chunk: int = 128):
    """Fused head projection + CE over token chunks: each chunk's logits
    live only inside a rematerialized chunk body, so the full (B, T, V)
    logits never exist."""
    B, T, _ = x.shape
    if T % chunk != 0:
        chunk = T

    def body(xc, lc):
        lf = (xc @ head_w.to(xc.dtype)).float()            # (B, chunk, V)
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, lc.clamp(min=0).long()[..., None])[..., 0]
        mask = (lc >= 0).float()
        return torch.sum((lse - gold) * mask), mask.sum()

    s = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        cs, cn = checkpoint(body, x[:, c0:c0 + chunk],
                            labels[:, c0:c0 + chunk], use_reentrant=False)
        s, n = s + cs, n + cn
    return s / torch.clamp(n, min=1.0)
