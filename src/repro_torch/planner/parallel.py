"""Parallel multi-sequence planning (the port's copy of the reference's
``repro.planner.parallel``).

``make_batch`` plans ``batch_per_host`` packed sequences per step; each
plan is numpy-dominated and releases the GIL for most of its runtime, so
a small thread pool overlaps them.  The pool is thread- (not process-)
based: plans are built from shared ``PlanCache`` state and the arrays
never need pickling.  Results come back in input order, so the plans do
not depend on the pool's width.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from repro_torch import obs

__all__ = ["PlannerPool", "get_pool", "default_workers", "plan_many"]


class PlannerPool:
    """Thin ThreadPoolExecutor wrapper that preserves input order."""

    def __init__(self, max_workers: int):
        self.max_workers = max(int(max_workers), 1)
        self._ex = ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix="repro_torch-planner") \
            if self.max_workers > 1 else None

    def map(self, fn: Callable, items: Sequence) -> list:
        if self._ex is None or len(items) <= 1:
            return [fn(x) for x in items]
        return list(self._ex.map(fn, items))


_POOLS: dict[int, PlannerPool] = {}
_POOLS_LOCK = threading.Lock()


def get_pool(max_workers: int) -> PlannerPool:
    """Shared per-process pool (one per worker count, made at first
    use; the prefetch thread and the caller may ask at once)."""
    max_workers = max(int(max_workers), 1)
    with _POOLS_LOCK:
        if max_workers not in _POOLS:
            _POOLS[max_workers] = PlannerPool(max_workers)
        return _POOLS[max_workers]


def default_workers(batch: int) -> int:
    """Pool width for one host batch: no wider than the batch, capped by
    the host's CPU count (minus one for the training loop)."""
    cpus = os.cpu_count() or 1
    return max(1, min(int(batch), cpus - 1))


def plan_many(plan_fn: Callable, lens_list: Sequence, *,
              workers: int = 0) -> list:
    """Plan every length mix in ``lens_list``, in order; ``workers=0``
    auto-sizes."""
    if workers <= 0:
        workers = default_workers(len(lens_list))
    with obs.span("plan"):
        return get_pool(workers).map(plan_fn, lens_list)
