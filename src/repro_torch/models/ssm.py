"""Mamba (selective SSM) mixer, the non-attention layers of Jamba (the
port of the reference's ``repro.models.ssm``).

Training path: the chunked selective scan through
``ctx.selective_scan`` (a CP context carries the state across ranks).
Document resets: the decay is zeroed at intra-doc position 0, so no
state crosses a document boundary.  The depthwise causal convolution
reads the ``d_conv - 1`` tokens before each token; under CP the first
of a rank's tokens read the last ones of the rank before it, which the
context's ``halo`` hook brings (the reference's GSPMD halo exchange),
and the pos mask keeps them out wherever a document starts.

Decode path: one-token recurrence with (conv window, SSM state) carried
in the cache.

Casts follow the reference's JAX promotion: an f32 activation times a
bf16 weight (``dt_r @ dt_proj``) is an f32 product of the weight cast
up, ``A = -exp(A_log)`` is taken in the stored dtype, and y is cast to
the activation dtype before ``+ x_c * D``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_cache_init"]


def mamba_init(stacked, d: int, *, periods: int, expand: int,
               d_state: int, d_conv: int, dtype, device):
    """One Mamba sub-tree, every leaf stacked on a leading axis of
    ``periods``.  ``stacked(shape, fan_in)`` draws He-normal matrices;
    the rest start as the reference's: conv bias 0, dt bias -2 (softplus
    gives a small dt), A_log = log(1..d_state), D = 1."""
    di = expand * d
    dt_rank = max(1, d // 16)

    def full(value, *shape):
        return torch.full((periods, *shape), value, dtype=dtype,
                          device=device)

    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": stacked((d, 2 * di), d),
        "conv_w": stacked((d_conv, di), d_conv),
        "conv_b": full(0.0, di),
        "x_proj": stacked((di, dt_rank + 2 * d_state), di),
        "dt_proj": stacked((dt_rank, di), dt_rank),
        "dt_bias": full(-2.0, di),
        "A_log": a_log.expand(periods, di, d_state).to(dtype).contiguous(),
        "D": full(1.0, di),
        "out_proj": stacked((di, d), di),
    }


def _causal_conv(p, x, pos, d_conv: int, halo=None):
    """Depthwise causal conv with document resets.  The contribution of
    x_{t-k} is masked unless the token is at least k tokens into its
    document (pos >= k).  ``halo`` (B, d_conv - 1, di) holds the tokens
    before ``x``'s first (zeros: none)."""
    w = p["conv_w"].to(x.dtype)
    n = d_conv - 1
    if halo is None:
        halo = x.new_zeros((x.shape[0], n, x.shape[2]))
    xp = torch.cat([halo.to(x.dtype), x], 1)
    T = x.shape[1]
    out = x * w[-1]
    for k in range(1, d_conv):
        ok = (pos >= k)[..., None].to(x.dtype)
        out = out + xp[:, n - k:n - k + T] * ok * w[-1 - k]
    return out + p["conv_b"].to(x.dtype)


def mamba_apply(p, x, ctx, *, d_state: int, d_conv: int):
    """x (B, T, d) -> (B, T, d)."""
    dt_rank = p["dt_proj"].shape[0]
    x_in, z = torch.chunk(x @ p["in_proj"].to(x.dtype), 2, dim=-1)
    halo_fn = ctx.extras.get("halo")
    halo = None if halo_fn is None else halo_fn(x_in, d_conv - 1)
    x_c = F.silu(_causal_conv(p, x_in, ctx.pos, d_conv, halo))

    proj = x_c @ p["x_proj"].to(x.dtype)
    dt_r = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + d_state].float()
    Cm = proj[..., dt_rank + d_state:].float()
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float()
                    + p["dt_bias"].float())                     # (B,T,di)

    A = -torch.exp(p["A_log"])                                  # (di, S)
    reset = (ctx.pos > 0).float()
    y = ctx.selective_scan(dt, A, Bm, Cm, x_c.float(), reset).to(x.dtype)

    y = y + x_c * p["D"].to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
def mamba_cache_init(periods: int, batch: int, d: int, *, expand: int,
                     d_state: int, d_conv: int, dtype, device):
    di = expand * d
    return {
        "conv": torch.zeros((periods, batch, d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((periods, batch, di, d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p, x_t, cache, *, d_state: int, d_conv: int):
    """One token step.  x_t (B, d) -> (y (B, d), {"conv", "ssm"} new
    states); ``cache`` is read, not written."""
    dt_rank = p["dt_proj"].shape[0]
    x_in, z = torch.chunk(x_t @ p["in_proj"].to(x_t.dtype), 2, dim=-1)

    w = p["conv_w"].to(x_t.dtype)                        # (d_conv, di)
    window = torch.cat([cache["conv"], x_in[:, None]], 1)
    x_c = F.silu(torch.einsum("bkd,kd->bd", window, w)
                 + p["conv_b"].to(x_t.dtype))

    proj = x_c @ p["x_proj"].to(x_t.dtype)
    dt_r = proj[..., :dt_rank]
    Bm = proj[..., dt_rank:dt_rank + d_state].float()
    Cm = proj[..., dt_rank + d_state:].float()
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float()
                    + p["dt_bias"].float())

    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                     # (B, di, S)
    bx = (dt * x_c.float())[..., None] * Bm[:, None, :]
    h = a * cache["ssm"] + bx
    y = torch.einsum("bds,bs->bd", h, Cm).to(x_t.dtype)
    y = y + x_c * p["D"].to(x_t.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x_t.dtype), {"conv": window[:, 1:], "ssm": h}

