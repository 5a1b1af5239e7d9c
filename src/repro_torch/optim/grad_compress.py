"""Gradient compression for the data-parallel reduction (the port of the
reference's ``repro.optim.grad_compress``).

* ``topk``: keep the k largest-magnitude entries of each leaf (k =
  ``topk_frac`` of its elements, at least 1; ties at the threshold kept).
* ``int8``: per-leaf symmetric int8 quantization, scale max|g| / 127,
  rounding half to even (as ``jnp.round`` and ``torch.round`` both do).

Each returns the sent values in the gradient's dtype and the residual
``g + ef - sent`` in f32 (error feedback).  The training step compresses
after clipping with zero error feedback on every step, as the reference
does.  The saving is the wire format, modelled by :func:`wire_bytes`.

Compression is per *whole* leaf.  Under ZeRO-3 a rank holds shards, so
the per-leaf statistics (int8's max|g|, topk's k-th largest |g|) come
from ``layout`` (:class:`repro_torch.runtime.zero.Zero3`), which finds
them exactly over the shards of every rank.
"""

from __future__ import annotations

import torch

from ._slices import leaves

__all__ = ["ef_init", "compress_tree", "wire_bytes"]

SCHEMES = ("none", "topk", "int8")


def ef_init(params):
    """Zero error feedback, f32, shaped like ``params``."""
    if isinstance(params, dict):
        return {k: ef_init(v) for k, v in params.items()}
    return torch.zeros(params.shape, dtype=torch.float32,
                       device=params.device)


def _unflatten(like, flat):
    it = iter(flat)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        return next(it)

    return go(like)


def compress_tree(grads, ef, scheme: str, *, topk_frac: float = 0.05,
                  layout=None):
    """Returns (compressed grads, new error feedback).  ``ef`` None is
    zero error feedback.  ``layout``: the ZeRO-3 layout when ``grads``
    are this rank's shards of the whole leaves."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown gradient compression {scheme!r}; use "
                         f"one of {SCHEMES}")
    if scheme == "none":
        return grads, ef
    gs = leaves(grads)
    es = [None] * len(gs) if ef is None else leaves(ef)
    gf = [g.float() if e is None else g.float() + e for g, e in zip(gs, es)]
    if scheme == "int8":
        amax = [x.abs().max() for x in gf] if layout is None \
            else layout.leaf_amax(gf)
        sent = []
        for x, m in zip(gf, amax):
            scale = torch.clamp(m, min=1e-12) / 127.0
            sent.append(torch.clamp(torch.round(x / scale), -127, 127)
                        * scale)
    else:
        numel = [x.numel() for x in gf] if layout is None \
            else layout.numels()
        ks = [max(1, int(n * topk_frac)) for n in numel]
        thresh = [torch.topk(x.abs().reshape(-1), k).values[-1]
                  for x, k in zip(gf, ks)] if layout is None \
            else layout.leaf_kth(gf, ks)
        sent = [x * (x.abs() >= t).float() for x, t in zip(gf, thresh)]
    out = [s.to(g.dtype) for s, g in zip(sent, gs)]
    return _unflatten(grads, out), _unflatten(
        grads, [x - s for x, s in zip(gf, sent)])


def wire_bytes(params, scheme: str, *, topk_frac: float = 0.05) -> int:
    """Bytes on the wire per data-parallel reduction of ``params`` (whole
    leaves) under each scheme."""
    n = sum(x.numel() for x in leaves(params))
    if scheme == "topk":
        return int(n * topk_frac) * 8          # (index, value) pairs
    if scheme == "int8":
        return n * 1 + 4
    return n * 4
