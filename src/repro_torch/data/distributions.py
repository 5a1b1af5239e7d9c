"""Synthetic document-length distributions for the paper's three datasets
(the port's own copy of ``repro.data.distributions``, held against it by
``tests/test_torch_train.py``).

The original corpora are unavailable offline; per DESIGN.md §8 we synthesize
lengths from the published *shape* of each distribution:

* ``wlb_llm``   — the production Meta distribution released with WLB-LLM is
  highly skewed with extremely long documents (paper §4.2 "WLB-LLM is more
  skewed with extremely long documents").  Modeled as a lognormal body with
  a Pareto tail reaching the full context window.
* ``pile``      — The Pile: predominantly shorter web/academic documents.
* ``redpajama`` — RedPajama: CommonCrawl-dominated short docs mixed with a
  minority of long code/arXiv/book documents.

Lengths are in tokens.  All samplers are deterministic given a
``numpy.random.Generator``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["DATASETS", "sample_doc_length", "make_rng"]


def make_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.PCG64(seed))


def _lognormal(rng, mu, sigma, lo, hi):
    x = rng.lognormal(mean=mu, sigma=sigma)
    return int(np.clip(x, lo, hi))


def _wlb_llm(rng: np.random.Generator) -> int:
    # 90% lognormal body around ~2-3K tokens; 10% Pareto tail of very long
    # documents (up to the context window) — the skew WLB-LLM reports.
    if rng.random() < 0.10:
        x = (rng.pareto(1.1) + 1.0) * 8192.0
        return int(np.clip(x, 8192, 131072))
    return _lognormal(rng, mu=7.8, sigma=1.1, lo=64, hi=131072)


def _pile(rng: np.random.Generator) -> int:
    # mostly short documents (median ~1K tokens), thin tail.
    return _lognormal(rng, mu=6.9, sigma=1.0, lo=32, hi=65536)


def _redpajama(rng: np.random.Generator) -> int:
    # 85% short CommonCrawl/C4-style docs, 15% long code/arXiv/book docs.
    if rng.random() < 0.15:
        return _lognormal(rng, mu=9.2, sigma=0.9, lo=1024, hi=131072)
    return _lognormal(rng, mu=6.6, sigma=0.9, lo=32, hi=32768)


DATASETS: dict[str, Callable[[np.random.Generator], int]] = {
    "wlb_llm": _wlb_llm,
    "pile": _pile,
    "redpajama": _redpajama,
}


def sample_doc_length(dataset: str, rng: np.random.Generator) -> int:
    try:
        return DATASETS[dataset](rng)
    except KeyError:
        raise KeyError(f"unknown dataset {dataset!r}; have {sorted(DATASETS)}")
