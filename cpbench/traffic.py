"""The one traffic generator: it reads a mix file (``mixes/<name>.json``)
and makes, for ``(seed, step)``, the rows of one training batch in
packed order (document lengths, tokens, next-token labels).

Every step trains fresh rows, drawn as the mix's sampler draws them:
step ``s``'s document lengths are packed with the frozen sampler
(``samplers.py``) from the generator of ``(sizes_seed, s)``.  So the
planner plans a new batch every step, the window sees the mix's spread
of rows, and every seed does the same work in the same order of steps.
A run's ``--seed`` draws, for each step, the order of the documents in
each row and the row's tokens.

A mix file holds::

    {"context_len": 16384, "rows": 1, "min_doc_len": 16,
     "lengths": [<component>, ...],          # samplers.sample_length
     "sizes_seed": 0,
     "tokens": {"zipf_a": 1.3, "repeat_p": 0.25}}
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .samplers import labels_of, make_rng, pack_sequence, synth_tokens

__all__ = ["Row", "Traffic", "attention_work"]


@dataclasses.dataclass(frozen=True)
class Row:
    """One packed sequence: its document lengths, tokens and labels, in
    packed order."""
    doc_lens: np.ndarray
    tokens: np.ndarray
    labels: np.ndarray


def attention_work(doc_lens) -> int:
    """Σ L (L + 1) / 2 over the documents: the causal pairs the
    attention of one head needs."""
    lens = np.asarray(doc_lens, dtype=np.int64)
    return int(np.sum(lens * (lens + 1) // 2))


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 64)


class Traffic:
    """The rows of every step of one run of one mix."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab_size = int(vocab_size)
        self.seed = _seed64(seed)
        self.context_len = int(mix["context_len"])

    def sizes(self, step: int) -> list[np.ndarray]:
        """Step ``step``'s rows' document lengths, in drawn order: the
        same for every seed."""
        mix = self.mix
        rng = make_rng([_seed64(mix["sizes_seed"]), int(step)])
        return [pack_sequence(mix["lengths"], self.context_len, rng,
                              min_doc_len=mix.get("min_doc_len", 16))
                for _ in range(mix["rows"])]

    def rows(self, step: int) -> list[Row]:
        """Step ``step``'s rows: its documents in an order drawn from
        (seed, step), with tokens drawn from the same stream."""
        rng = make_rng([self.seed, int(step)])
        tok = self.mix["tokens"]
        out = []
        for lens in self.sizes(step):
            lens = lens[rng.permutation(len(lens))]
            tokens = synth_tokens(rng, int(lens.sum()), self.vocab_size,
                                  zipf_a=tok["zipf_a"],
                                  repeat_p=tok["repeat_p"])
            out.append(Row(lens, tokens, labels_of(tokens, lens)))
        return out
