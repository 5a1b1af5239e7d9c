"""Execution context: the seam between model code and the attention
runtime (the port of the reference's ``repro.models.context``).

Model code is written against :class:`ExecContext` and never mentions
tables or ranks.  ``doc``/``pos`` are per-token metadata in plan order;
``attn(q, k, v)`` maps q (B, Hq, T, D) and k, v (B, Hkv, T, D) to
(B, Hq, T, D).  ``ssm_scan(a, x)`` is the elementwise recurrence
h_t = a_t h_{t-1} + x_t over the T axis of (B, T, ...) tensors (``a``
may keep singleton trailing dims: the decay stays in broadcast shape),
and ``selective_scan(dt, A, Bm, Cm, xf, reset)`` the fused Mamba scan;
document resets are encoded by the caller as a zero decay at pos == 0.
A CP context carries both across its ranks.  ``extras`` carries the
MoE hooks of a CP context (``ep_dispatch``, the expert-parallel
all-to-all island, and ``token_sum``, a differentiable sum over the
ranks that hold the batch's other tokens) and ``halo(x, n)``, the last
``n`` entries along axis 1 of the previous rank's ``x`` (Mamba's
causal convolution reads tokens, the mLSTM its chunk states); a local
context has none of them.

The scans are exact in f32 up to rounding: inside a chunk they run a
log-depth doubling (Hillis-Steele) over the chunk's tokens, where the
reference runs ``jax.lax.associative_scan`` (``local_ssm_scan``) or a
sequential ``lax.scan`` (``local_selective_scan``); the sums are the
same, associated in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["ExecContext", "make_local_context", "local_ssm_scan",
           "local_selective_scan"]


# --------------------------------------------------------------------- #
# local (no-CP) scans
# --------------------------------------------------------------------- #
def _doubling(a, x, dim: int):
    """Inclusive scan of h_t = a_t h_{t-1} + x_t along ``dim`` from a
    zero state, in log2(n) steps: returns (the running products of
    ``a``, at ``a``'s shape, and h, at ``x``'s)."""
    n, s = x.shape[dim], 1
    while s < n:
        lo_a, hi_a = a.narrow(dim, 0, n - s), a.narrow(dim, s, n - s)
        x = torch.cat([x.narrow(dim, 0, s),
                       x.narrow(dim, s, n - s) + hi_a * x.narrow(dim, 0,
                                                                 n - s)],
                      dim)
        a = torch.cat([a.narrow(dim, 0, s), hi_a * lo_a], dim)
        s *= 2
    return a, x


def _two_level(a, x, chunk: int):
    """h of the recurrence over axis 1 in chunks: a doubling inside every
    chunk at once, one over the chunks' end states, then each chunk's
    carry-in added through its running decay."""
    B, T = x.shape[:2]
    nc = T // chunk
    ac = a.reshape(B, nc, chunk, *a.shape[2:])
    xc = x.reshape(B, nc, chunk, *x.shape[2:])
    P, H = _doubling(ac, xc, 2)
    _, ends = _doubling(P[:, :, -1], H[:, :, -1], 1)
    prev = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    return (H + P * prev[:, :, None]).reshape(x.shape)


def local_ssm_scan(a: torch.Tensor, x: torch.Tensor, *,
                   init: torch.Tensor | None = None,
                   chunk: int = 64) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t along axis 1; ``init`` is h_{-1}
    (default zeros).  ``a`` is (B, T, ...) at ``x``'s shape or with
    singleton trailing dims.  Rematerialized: the backward recomputes
    the scan from its inputs, so only ``a`` and ``x`` are kept."""
    if init is not None:
        x = torch.cat([x[:, :1] + a[:, :1] * init[:, None], x[:, 1:]], 1)
    T = x.shape[1]
    if T % chunk != 0 or T <= chunk:
        return checkpoint(lambda a, x: _doubling(a, x, 1)[1], a, x,
                          use_reentrant=False)
    return checkpoint(_two_level, a, x, chunk, use_reentrant=False)


def _selective_terms(A, dt, Bm, xf, reset):
    """Per-token decay exp(dt A) (zeroed at document starts) and input
    dt x B of one chunk: (B, c, di, S) f32 each."""
    a = torch.exp(dt.float()[..., None] * A) * reset[:, :, None, None]
    b = (dt * xf).float()[..., None] * Bm[:, :, None, :]
    return a, b


def _selective_chunk(h, A, dt, Bm, Cm, xf, reset):
    """One chunk from state h (B, di, S): (its last state, y (B, c, di))."""
    a, b = _selective_terms(A, dt, Bm, xf, reset)
    P, H = _doubling(a, b, 1)
    hs = H + P * h[:, None]
    y = torch.einsum("btds,bts->btd", hs, Cm.float())
    return hs[:, -1], y


def _summary_chunk(pA, h, A, dt, Bm, xf, reset):
    """One chunk of the summary pass: (decay product, state) updated."""
    a, b = _selective_terms(A, dt, Bm, xf, reset)
    P, H = _doubling(a, b, 1)
    return pA * P[:, -1], H[:, -1] + P[:, -1] * h


def local_selective_scan(dt, A, Bm, Cm, xf, reset, *, chunk: int = 64,
                         init_state=None, summary_only: bool = False):
    """y_t = C_t · h_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t.

    dt, xf (B, T, di); Bm, Cm (B, T, S); A (di, S); reset (B, T), 0 at
    document starts.  Chunks of ``chunk`` tokens (halved until it
    divides T; under CP, T is the rank's own token count, which changes
    the chunking and not the result) are each rematerialized in the
    backward, so only the (B, di, S) state between chunks is kept: the
    (T, di, S) decay and input tensors exist one chunk at a time.

    ``init_state`` (B, di, S) seeds the recurrence (the CP rank
    hand-off); ``summary_only`` returns (decay product, final state),
    each (B, di, S), for the CP prefix exchange, without y."""
    B, T, di = dt.shape
    ck = chunk
    while T % ck:
        ck //= 2
    h = torch.zeros((B, di, A.shape[-1]), dtype=torch.float32,
                    device=dt.device) if init_state is None \
        else init_state.float()
    spans = [slice(c, c + ck) for c in range(0, T, ck)]
    if summary_only:
        pA = torch.ones_like(h)
        for sl in spans:
            pA, h = checkpoint(_summary_chunk, pA, h, A, dt[:, sl],
                               Bm[:, sl], xf[:, sl], reset[:, sl],
                               use_reentrant=False)
        return pA, h
    ys = []
    for sl in spans:
        h, y = checkpoint(_selective_chunk, h, A, dt[:, sl], Bm[:, sl],
                          Cm[:, sl], xf[:, sl], reset[:, sl],
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1)


# --------------------------------------------------------------------- #
# the context
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class ExecContext:
    doc: torch.Tensor
    pos: torch.Tensor
    attn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    ssm_scan: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = \
        local_ssm_scan
    # fused chunkwise selective scan (Mamba): (dt, A, Bm, Cm, xf, reset)->y
    selective_scan: Callable = local_selective_scan
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)


def make_local_context(doc: torch.Tensor, pos: torch.Tensor,
                       attention_impl: str = "plain", q_chunk: int = 512,
                       grid: str = "flat") -> ExecContext:
    """Single-device context: full-sequence doc-masked attention and the
    local scans.

    ``attention_impl="flash"`` runs the training kernels on visit tables
    built from (doc, pos) once, on first use; ``"plain"`` the chunked
    dense attention."""
    from repro_torch.kernels import ops as kops

    if attention_impl not in ("flash", "plain"):
        raise ValueError(f"unknown attention impl {attention_impl!r}")
    tabs_cache: list = []   # the tables depend only on (doc, pos)

    def attn(q, k, v):
        if attention_impl == "flash":
            if not tabs_cache:
                from repro_torch.kernels.doc_attention import \
                    build_block_tables
                d, p = doc.cpu().numpy(), pos.cpu().numpy()
                tabs_cache.append(build_block_tables(d, p, d, p))
            return kops.doc_flash_attention(q, k, v, doc, pos, doc, pos,
                                            tabs_cache[0], grid=grid)
        return kops.doc_attention_plain(q, k, v, doc, pos, doc, pos,
                                        q_chunk=q_chunk)

    return ExecContext(doc=doc, pos=pos, attn=attn)
