"""Content-addressed result cache for tuned configs (DESIGN.md §Autotune).

A tuning run is a pure function of ``(model dims, mesh/problem geometry,
length-profile signature, search space, hardware constants, tuner
version)``; its result is
stored under the blake2b digest of that tuple's canonical JSON, exactly
the :class:`repro_torch.planner.cache.PlanCache` recipe one level up.  The
length profile is signed by the *quantized sorted* pool lengths
(:data:`LENGTH_QUANTUM`-token buckets), so a re-sampled pool with the
same shape distribution hits the same entry while a genuinely different
mix does not.

Entries are one JSON file per key with atomic tmp+rename writes, so a
crashed tuner never leaves a torn entry and concurrent writers of the
same key converge on identical bytes (payloads are deterministic).
Corrupt or unreadable entries read as misses.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np

from .cost_model import HW

__all__ = ["ResultCache", "tune_signature", "signature_key",
           "LENGTH_QUANTUM", "TUNER_VERSION"]

#: doc lengths are bucketed to this many tokens in the cache signature
LENGTH_QUANTUM = 64

#: bump on any change to the search semantics or payload schema — old
#: entries then simply miss instead of deserializing wrongly
TUNER_VERSION = 1


def tune_signature(problem, dims, pool, space, hw=HW) -> dict:
    """The canonical identity of one tuning run (JSON-safe dict).  It
    carries the cost constants ``hw``: a cache directory shared between
    cards (or with the reference's tuner, whose signature has no
    ``"hw"``) never serves one card's pick to another."""
    lens = np.asarray(pool, dtype=np.int64)
    qlens = np.sort((np.maximum(lens, 1) + LENGTH_QUANTUM - 1)
                    // LENGTH_QUANTUM * LENGTH_QUANTUM)
    return {
        "version": TUNER_VERSION,
        "problem": problem.as_dict(),
        "dims": dataclasses.asdict(dims),
        "space": space.as_dict(),
        "hw": dict(hw),
        "pool": {"n_docs": int(lens.size),
                 "total_tokens": int(lens.sum()),
                 "qlens": qlens.tolist()},
    }


def signature_key(signature: dict) -> str:
    blob = json.dumps(signature, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


class ResultCache:
    """Filesystem-backed content-addressed store of tune payloads.

    ``root=None`` (or empty) disables persistence — every lookup misses
    and puts are dropped — so callers never branch on "cache configured".
    """

    def __init__(self, root: str | os.PathLike | None):
        self.root = Path(root) if root else None
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> Path:
        assert self.root is not None
        return self.root / f"tune_{key}.json"

    def get(self, key: str) -> dict | None:
        if self.root is None:
            self.misses += 1
            return None
        try:
            payload = json.loads(self._path(key).read_text())
        except (OSError, ValueError):
            self.misses += 1
            return None
        if payload.get("version") != TUNER_VERSION:
            self.misses += 1
            return None
        self.hits += 1
        return payload

    def put(self, key: str, payload: dict) -> Path | None:
        if self.root is None:
            return None
        self.root.mkdir(parents=True, exist_ok=True)
        final = self._path(key)
        blob = json.dumps(payload, sort_keys=True, indent=1)
        tmp = final.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(blob)
        os.replace(tmp, final)      # atomic within one filesystem
        return final
