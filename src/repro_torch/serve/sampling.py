"""Token sampling for the serving engine: greedy + temperature / top-k.

Per-row parameters ride as arrays so one call serves a heterogeneous
batch: ``temperature`` (B,), 0 selects greedy argmax for that row;
``top_k`` (B,), 0 disables the top-k filter for that row.  Greedy rows
are a bitwise argmax (first index among ties), the only sampling mode
held against the JAX package.

Determinism: row b draws its Gumbel noise from a ``torch.Generator``
seeded by ``(engine seed, rid, n_generated)``, so each request owns its
own stream, indexed by how many tokens it has produced.  Two identical
concurrent requests sample independently (different rids), and any
request reproduces bit for bit given the engine seed, whatever slot it
landed in and whatever shared the batch.  The noise is drawn on the CPU,
so a stream is the same on every device.  By design these streams are
not the JAX package's ``fold_in`` streams.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["apply_top_k", "sample_tokens_keyed"]


def apply_top_k(logits, top_k):
    """Mask logits outside each row's top-k.  logits (B, V); top_k (B,)
    int, 0 = no restriction.  Ties at the k-th value are kept."""
    V = logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=logits.device).long()
    srt = torch.sort(logits, dim=-1).values                 # ascending
    idx = torch.clamp(V - torch.clamp(top_k, min=1), 0, V - 1)
    thr = torch.gather(srt, 1, idx[:, None])
    keep = (top_k <= 0)[:, None] | (logits >= thr)
    return logits.masked_fill(~keep, float("-inf"))


def _stream_seed(seed: int, rid: int, count: int) -> int:
    state = np.random.SeedSequence([seed, rid, count]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 32 | int(state[1])) & (2 ** 63 - 1)


def sample_tokens_keyed(seed: int, rids, counts, logits, temperature,
                        top_k) -> torch.Tensor:
    """One token per row.  logits (B, V); rids, counts, temperature,
    top_k: host arrays of length B.  Returns (B,) int64 on the logits'
    device."""
    greedy = torch.argmax(logits, dim=-1)
    temperature = np.asarray(temperature, np.float32)
    hot = np.flatnonzero(temperature > 0)
    if hot.size == 0:
        return greedy
    rows = torch.as_tensor(hot, device=logits.device)
    scaled = apply_top_k(logits[rows].float(),
                         np.asarray(top_k, np.int64)[hot]) \
        / torch.as_tensor(temperature[hot], device=logits.device)[:, None]
    V = logits.shape[-1]
    noise = torch.empty((hot.size, V), dtype=torch.float32)
    gen = torch.Generator()
    for i, b in enumerate(hot):
        gen.manual_seed(_stream_seed(seed, int(rids[b]), int(counts[b])))
        u = torch.rand(V, generator=gen).clamp_(min=1e-20)
        noise[i] = -torch.log(-torch.log(u))                 # Gumbel(0, 1)
    sampled = torch.argmax(scaled + noise.to(logits.device), dim=-1)
    out = greedy.clone()
    out[rows] = sampled
    return out
