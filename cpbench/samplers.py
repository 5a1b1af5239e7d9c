"""The benchmark's frozen copy of the port's document samplers, packing
and token model (``repro_torch/data/distributions.py``,
``data/packing.py`` and ``data/pipeline.py::_synthesize_row``), written
as one parametric sampler that a mix file drives.

A length distribution is a list of components.  With one component no
uniform is drawn; with more, one ``rng.random()`` picks the first
component whose cumulative ``p`` exceeds it (the last takes the rest).
A component is ``lognormal`` (``int(clip(rng.lognormal(mu, sigma), lo,
hi))``) or ``pareto`` (``int(clip((rng.pareto(alpha) + 1) * scale, lo,
hi))``).  These are the port's draws, in its order:
``tests/test_cpbench_traffic.py`` holds them equal to the port's
``wlb_llm`` and ``pile`` samplers and to its packing.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_rng", "sample_length", "pack_sequence", "synth_tokens",
           "labels_of"]


def make_rng(seed) -> np.random.Generator:
    """The port's generator: PCG64 from ``seed``."""
    return np.random.default_rng(np.random.PCG64(seed))


def _component(rng: np.random.Generator, c: dict) -> int:
    if c["kind"] == "lognormal":
        x = rng.lognormal(mean=c["mu"], sigma=c["sigma"])
    elif c["kind"] == "pareto":
        x = (rng.pareto(c["alpha"]) + 1.0) * c["scale"]
    else:
        raise ValueError(f"unknown length component {c['kind']!r}")
    return int(np.clip(x, c["lo"], c["hi"]))


def sample_length(rng: np.random.Generator, components: list[dict]) -> int:
    """One document length from a mixture of ``components``."""
    if len(components) == 1:
        return _component(rng, components[0])
    u, acc = rng.random(), 0.0
    for c in components[:-1]:
        acc += c["p"]
        if u < acc:
            return _component(rng, c)
    return _component(rng, components[-1])


def pack_sequence(components: list[dict], context_len: int,
                  rng: np.random.Generator, *,
                  min_doc_len: int = 16) -> np.ndarray:
    """Document lengths summing to ``context_len``: documents drawn until
    the window is full, the last cut to fit, scraps shorter than
    ``min_doc_len`` merged into the previous document."""
    lens: list[int] = []
    total = 0
    while total < context_len:
        d = min(sample_length(rng, components), context_len - total)
        if d < min_doc_len and total + d < context_len and lens:
            lens[-1] += d
        else:
            lens.append(d)
        total += d
    return np.asarray(lens, dtype=np.int64)


def synth_tokens(rng: np.random.Generator, n_tok: int, vocab_size: int, *,
                 zipf_a: float, repeat_p: float) -> np.ndarray:
    """Zipfian unigrams with repetition bigrams, in packed order: one
    zipf and one uniform draw per sequence."""
    packed = ((rng.zipf(zipf_a, n_tok) - 1) % vocab_size).astype(np.int32)
    rep = rng.random(n_tok) < repeat_p
    rep[0] = False
    prev = np.maximum(np.arange(n_tok) - 1, 0)
    return np.where(rep, packed[prev], packed).astype(np.int32)


def labels_of(tokens: np.ndarray, doc_lens: np.ndarray) -> np.ndarray:
    """Next-token labels in packed order; -1 at each document's last
    token."""
    labels = np.empty_like(tokens)
    labels[:-1] = tokens[1:]
    labels[np.cumsum(doc_lens) - 1] = -1
    return labels
