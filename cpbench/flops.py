"""The yardstick's arithmetic: a step's model FLOPs, the attention's
need in FLOPs and bytes, and the card's published peaks
(``peaks.json``).

Model FLOPs are 6 x the non-embedding parameters (the output head's
matrix included, tied to the embedding table or not: it is a matrix
product every token) per token, plus the attention the
documents need: per document of length L, 4 Hq d_head L (L + 1) / 2 a
layer in the forward, three times that with the backward.  They come
from the rows' document lengths, never from the blocks or tiles a
kernel visits, so every implementation of the attention is credited
the same work.  Rematerialization is not counted.
"""

from __future__ import annotations

import json

import numpy as np

from .manifest import HERE

__all__ = ["nonembedding_params", "linear_flops", "attention_flops",
           "attention_bytes", "window_flops", "peaks"]


def nonembedding_params(spec) -> int:
    d, hd = spec.d_model, spec.head_dim
    q, kv = spec.heads * hd, spec.kv_heads * hd
    per_layer = d * q + 2 * d * kv + q * d + 2 * d * spec.d_ff + 2 * d
    return spec.layers * per_layer + d + d * spec.vocab


def linear_flops(spec, tokens: int) -> float:
    return 6.0 * nonembedding_params(spec) * tokens


def attention_flops(spec, doc_lens) -> float:
    """Forward and backward FLOPs of the causal attention inside the
    documents ``doc_lens`` (one row's, or every row's together)."""
    lens = np.asarray(doc_lens, dtype=np.float64)
    pairs = float(np.sum(lens * (lens + 1) / 2))
    return 3 * 4.0 * spec.heads * spec.head_dim * pairs * spec.layers


def attention_bytes(spec, tokens: int, dtype_bytes: int = 2) -> float:
    """Bytes the attention of a step has to move at least: q, k, v, o,
    dO, dQ, dK and dV each read or written once, and the f32 lse."""
    hd = spec.head_dim
    per_tok = (4 * spec.heads * hd + 4 * spec.kv_heads * hd) * dtype_bytes \
        + 4 * spec.heads
    return float(per_tok) * tokens * spec.layers


def window_flops(spec, steps) -> float:
    """Model FLOPs of a window's ``steps`` (each with ``doc_lens``: its
    rows' document lengths)."""
    return sum(linear_flops(spec, int(np.sum(lens)))
               + attention_flops(spec, lens)
               for s in steps for lens in s["doc_lens"])


def peaks(device_name: str) -> dict:
    """The published peaks of ``device_name`` (``peaks.json``)."""
    table = json.loads((HERE / "peaks.json").read_text())
    if device_name not in table:
        raise KeyError(f"no published peaks for {device_name!r}; have "
                       f"{sorted(table)}")
    return table[device_name]
