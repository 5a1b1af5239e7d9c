"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM
(scalar memory, a scan); the port of the reference's
``repro.models.xlstm``.

* mLSTM runs in the chunkwise-parallel form: decay-weighted attention
  inside a chunk, and the inter-chunk matrix state carried through
  ``ctx.ssm_scan`` (a CP context carries it across ranks).  The gates
  are sigmoid forget/input gates, the reference's stabilized
  simplification of the paper's exponential gating.
* sLSTM is an elementwise recurrence, mapped onto ``ctx.ssm_scan``.
* Document resets zero the forget gate at intra-doc position 0.
* Under CP the scans carry the chunk states across ranks, and a rank's
  first chunk reads the last state of the rank before it through the
  context's ``halo`` hook (where the reference's global shift of the
  chunk states is a GSPMD collective-permute).
* The blocks carry their own up/down projections (d_ff == 0).

Casts follow the reference's JAX promotion: the gate products of an f32
activation with a bf16 weight (``xu @ wf``, ``xu @ wi``, and every gate
of the sLSTM) are f32 products of the weight cast up.  The scans keep
the decay in broadcast (singleton) shape, so no (dh, dh) decay is ever
materialized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mlstm_init", "mlstm_apply", "mlstm_cache_init", "mlstm_decode",
           "slstm_init", "slstm_apply", "slstm_cache_init", "slstm_decode"]

_CHUNK = 64


# ===================================================================== #
# mLSTM
# ===================================================================== #
def mlstm_init(stacked, d: int, num_heads: int, *, expand: int = 2):
    """One mLSTM sub-tree; ``stacked(shape, fan_in)`` draws stacked
    He-normal matrices."""
    di = expand * d
    return {"up": stacked((d, 2 * di), d),
            "wq": stacked((di, di), di),
            "wk": stacked((di, di), di),
            "wv": stacked((di, di), di),
            "wf": stacked((di, num_heads), di),
            "wi": stacked((di, num_heads), di),
            "down": stacked((di, d), di)}


def mlstm_apply(p, x, ctx, *, num_heads: int):
    """x (B, T, d) -> (B, T, d).  Chunkwise-parallel linear attention with
    per-head scalar forget/input gates.  The chunk is at most ``_CHUNK``
    tokens, halved until it divides T; under CP, T is the rank's own
    token count, which changes the chunking and not the result."""
    B, T, _ = x.shape
    di = p["up"].shape[1] // 2
    H = num_heads
    dh = di // H

    xu, z = torch.chunk(x @ p["up"].to(x.dtype), 2, dim=-1)

    def heads(w):
        return (xu @ w.to(xu.dtype)).reshape(B, T, H, dh).transpose(1, 2)

    q = heads(p["wq"]) * (dh ** -0.5)                  # (B, H, T, dh)
    k = heads(p["wk"])
    v = heads(p["wv"])
    xf = xu.float()
    f = torch.sigmoid(xf @ p["wf"].float()).transpose(1, 2)   # (B, H, T)
    i = torch.sigmoid(xf @ p["wi"].float()).transpose(1, 2)
    f = f * (ctx.pos > 0)[:, None, :]                  # document reset

    c = min(_CHUNK, T)
    while T % c:
        c //= 2
    nc = T // c

    qf = q.reshape(B, H, nc, c, dh).float()
    kc = k.reshape(B, H, nc, c, dh).float()
    vc = v.reshape(B, H, nc, c, dh).float()
    fc = f.reshape(B, H, nc, c)
    ic = i.reshape(B, H, nc, c)

    lf = torch.log(torch.clamp(fc, min=1e-30))
    clf = torch.cumsum(lf, dim=-1)                     # inclusive, in-chunk

    # ---- intra-chunk: decay-weighted causal attention ------------------ #
    # W[t, s] = exp(clf_t - clf_s) i_s for s <= t; the anti-causal lanes
    # are clamped before the exp (their exp would be inf, and a zero
    # cotangent times inf is NaN in the backward)
    dmat = clf[..., :, None] - clf[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    dmat = torch.where(causal, dmat, torch.full_like(dmat, -1e30))
    w = torch.exp(dmat) * ic[..., None, :]
    scores = (qf @ kc.transpose(-1, -2)) * w
    intra = scores @ vc
    intra_n = w @ kc                                   # normalizer numerator

    # ---- inter-chunk: matrix state scan over chunks --------------------- #
    decay_chunk = torch.exp(clf[..., -1])                       # (B,H,nc)
    tail = torch.exp(clf[..., -1:] - clf) * ic                  # (B,H,nc,c)
    tk = tail[..., None] * kc
    dC = tk.transpose(-1, -2) @ vc                              # (B,H,nc,dh,dh)
    dN = tk.sum(dim=-2)                                         # (B,H,nc,dh)

    a_c = decay_chunk.transpose(1, 2)                           # (B,nc,H)
    C_states = ctx.ssm_scan(a_c[..., None, None],
                            dC.permute(0, 2, 1, 3, 4))          # (B,nc,H,dh,dh)
    N_states = ctx.ssm_scan(a_c[..., None], dN.permute(0, 2, 1, 3))
    # the states before each chunk (exclusive): under CP a rank's first
    # chunk starts from the previous rank's last state (the halo hook;
    # the reference's global shift), else from zero
    halo = ctx.extras.get("halo")

    def before(states):
        first = torch.zeros_like(states[:, :1]) if halo is None \
            else halo(states, 1)
        return torch.cat([first, states[:, :-1]], 1)

    C_prev, N_prev = before(C_states), before(N_states)

    qw = qf * torch.exp(clf)[..., None]                # decay from chunk start
    inter = qw @ C_prev.permute(0, 2, 1, 3, 4)
    inter_n = (qw * N_prev.permute(0, 2, 1, 3)[:, :, :, None]).sum(-1)

    num = intra + inter                                # (B,H,nc,c,dh)
    den = (qf * intra_n).sum(-1)[..., None] + inter_n[..., None]
    out = num / torch.clamp(torch.abs(den), min=1.0)
    out = out.reshape(B, H, T, dh).transpose(1, 2).reshape(B, T, di)
    out = out.to(x.dtype) * F.silu(z)
    return out @ p["down"].to(x.dtype)


def mlstm_cache_init(periods: int, batch: int, d: int, num_heads: int, *,
                     expand: int, device):
    dh = expand * d // num_heads
    return {"C": torch.zeros((periods, batch, num_heads, dh, dh),
                             dtype=torch.float32, device=device),
            "N": torch.zeros((periods, batch, num_heads, dh),
                             dtype=torch.float32, device=device)}


def mlstm_decode(p, x_t, cache, *, num_heads: int):
    """One token step: (y (B, d), {"C", "N"} new states); ``cache`` is
    read, not written."""
    B, _ = x_t.shape
    di = p["up"].shape[1] // 2
    H, dh = num_heads, di // num_heads

    xu, z = torch.chunk(x_t @ p["up"].to(x_t.dtype), 2, dim=-1)
    q = (xu @ p["wq"].to(xu.dtype)).reshape(B, H, dh).float() \
        * (dh ** -0.5)
    k = (xu @ p["wk"].to(xu.dtype)).reshape(B, H, dh).float()
    v = (xu @ p["wv"].to(xu.dtype)).reshape(B, H, dh).float()
    xf = xu.float()
    f = torch.sigmoid(xf @ p["wf"].float())                    # (B, H)
    i = torch.sigmoid(xf @ p["wi"].float())

    C = f[..., None, None] * cache["C"] \
        + i[..., None, None] * (k[..., :, None] * v[..., None, :])
    N = f[..., None] * cache["N"] + i[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = (q * N).sum(-1)[..., None]
    out = (num / torch.clamp(torch.abs(den), min=1.0)).reshape(B, di)
    out = out.to(x_t.dtype) * F.silu(z)
    return out @ p["down"].to(x_t.dtype), {"C": C, "N": N}


# ===================================================================== #
# sLSTM
# ===================================================================== #
def slstm_init(stacked, d: int):
    return {name: stacked((d, d), d)
            for name in ("wz", "wi", "wf", "wo", "down")}


def _slstm_gates(p, xf):
    z = torch.tanh(xf @ p["wz"].float())
    i = torch.sigmoid(xf @ p["wi"].float())
    f = torch.sigmoid(xf @ p["wf"].float())
    o = torch.sigmoid(xf @ p["wo"].float())
    return z, i, f, o


def slstm_apply(p, x, ctx):
    """x (B, T, d) -> (B, T, d).  c_t = f_t c_{t-1} + i_t z_t; h = o c."""
    z, i, f, o = _slstm_gates(p, x.float())
    f = f * (ctx.pos > 0).to(f.dtype)[..., None]
    c = ctx.ssm_scan(f, i * z)
    h = (o * c).to(x.dtype)
    return h @ p["down"].to(x.dtype)


def slstm_cache_init(periods: int, batch: int, d: int, *, device):
    return {"c": torch.zeros((periods, batch, d), dtype=torch.float32,
                             device=device)}


def slstm_decode(p, x_t, cache):
    """One token step: (y (B, d), {"c"} new state)."""
    z, i, f, o = _slstm_gates(p, x_t.float())
    c = f * cache["c"] + i * z
    h = (o * c).to(x_t.dtype)
    return h @ p["down"].to(x_t.dtype), {"c": c}
