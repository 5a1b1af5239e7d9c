"""Deterministic, host-sharded training batches (the port of the
reference's ``repro.data.pipeline``).

Per batch, per packed sequence:
  1. draw document lengths from the dataset distribution (seeded);
  2. resolve the configured CP planner through the
     :mod:`repro_torch.planner` registry and plan, one sequence after
     the other, through a :class:`~repro_torch.planner.cache.PlanCache`
     at exact signatures;
  3. encode the plans (permutation + Eq.-5 comm metadata,
     :func:`~repro_torch.planner.encode.encode_plan_batch`);
  4. synthesize tokens and next-token labels in *plan order*, and (for
     the kernels) emit the per-rank visit tables.

The stream for (seed, dp_rank, step) draws from the same seeded
``PCG64`` as the reference, in the same order, and plans through copies
of the same planners, so batches match it bit for bit at any CP size
(the reference with its default planner settings and serial planning).
The reference's planner knobs are constants here until a caller of the
port needs another value: the Eq.-5 bucket is chosen per batch, the
target imbalance is :data:`TARGET_IMBALANCE`, and the plan cache holds
:data:`PLAN_CACHE_ENTRIES` exact signatures.  :class:`Prefetcher` builds
the stream ahead on a background thread.  Global dispatch waits for a
later slice of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
from typing import Any, Iterator

import numpy as np

from repro_torch.core.cp_attention import resolve_overlap
from repro_torch.planner import (PlanCache, emit_visit_tables,
                                 encode_plan_batch, get_planner)
from .distributions import make_rng
from .packing import pack_sequence

__all__ = ["PipelineConfig", "make_batch", "exec_style_of", "data_iterator",
           "Prefetcher"]

# the FlashCP heuristic's target max/mean load ratio (planners that take one)
TARGET_IMBALANCE = 1.05
# least-recently-used plans kept per pipeline configuration
PLAN_CACHE_ENTRIES = 256


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataset: str = "wlb_llm"
    context_len: int = 131072
    batch_per_host: int = 1
    cp_size: int = 1
    strategy: str = "flashcp"
    vocab_size: int = 50304
    seed: int = 0
    align: int = 128             # T_loc alignment (kernel block size)
    # visit-table emission (attention_impl="flash" steps)
    emit_tables: bool = False
    table_overlap: str = "chunked"   # matches RunConfig.cp_overlap
    table_grid: str = "flat"         # matches RunConfig.kernel_grid
    table_block_q: int = 128
    table_block_k: int = 128


def exec_style_of(strategy: str) -> str:
    """The execution style the training steps run for a planner name
    (its registry metadata); an unknown name raises ``KeyError`` listing
    the available planners."""
    return get_planner(strategy).info.exec_style


@functools.lru_cache(maxsize=32)
def _plan_cache(cfg: PipelineConfig) -> PlanCache:
    """The plan cache of a config, made once."""
    planner = get_planner(cfg.strategy)
    kwargs = {}
    if planner.info.supports_target_ratio:
        kwargs["target_ratio"] = TARGET_IMBALANCE
    return PlanCache(planner, cfg.cp_size, max_entries=PLAN_CACHE_ENTRIES,
                     planner_kwargs=kwargs)


def _synthesize_row(tokens_row, labels_row, lens, perm, rng,
                    vocab_size: int) -> None:
    """Synthesize one sequence's tokens in packed order, then permute to
    plan order.  Zipfian unigrams + repetition bigrams; one zipf + one
    uniform draw per sequence (the draw order is part of the pipeline's
    determinism contract)."""
    n_tok = int(lens.sum())
    packed = ((rng.zipf(1.3, n_tok) - 1) % vocab_size
              ).astype(np.int32)
    rep = rng.random(n_tok) < 0.25
    rep[0] = False
    idx = np.arange(n_tok)
    prev = np.maximum(idx - 1, 0)
    packed = np.where(rep, packed[prev], packed)
    valid = perm >= 0
    tokens_row[valid] = packed[perm[valid]]
    # next-token labels: valid unless last token of its document
    nxt = perm + 1
    is_final = np.zeros_like(valid)
    ends = np.cumsum(lens) - 1
    is_final[valid] = np.isin(perm[valid], ends)
    lab_ok = valid & ~is_final
    labels_row[lab_ok] = packed[np.minimum(nxt[lab_ok],
                                           len(packed) - 1)]


def _synthesize_tokens(doc_lens_list, perm_stack, rng,
                       vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Batch token synthesis from one shared Generator, rows in order."""
    B, C_pad = perm_stack.shape
    tokens = np.full((B, C_pad), -1, np.int32)
    labels = np.full((B, C_pad), -1, np.int32)
    for b, lens in enumerate(doc_lens_list):
        _synthesize_row(tokens[b], labels[b], lens, perm_stack[b], rng,
                        vocab_size)
    return tokens, labels


def _emit_tables(cfg: PipelineConfig, stack: dict,
                 num_workers: int) -> dict[str, np.ndarray]:
    style = exec_style_of(cfg.strategy)
    needs_gath = style in ("flashcp", "contiguous")
    overlap = resolve_overlap(style, "flash", cfg.table_overlap)
    return emit_visit_tables(
        stack["doc"], stack["pos"],
        stack["gath_doc"] if needs_gath else None,
        stack["gath_pos"] if needs_gath else None,
        num_workers=num_workers, strategy=style,
        overlap=overlap, grid=cfg.table_grid,
        block_q=cfg.table_block_q, block_k=cfg.table_block_k)


def _batch_stats(encs, doc_lens_list, cache: PlanCache) -> dict:
    return {
        "comm_tokens": max(e.comm_tokens for e in encs),
        "buf_len": encs[0].buf_len,
        "t_loc": encs[0].t_loc,
        "imbalance": float(np.mean([e.imbalance for e in encs])),
        "num_docs": float(np.mean([len(l) for l in doc_lens_list])),
        "plan_cache_hit_rate": cache.stats.hit_rate,
    }


def make_batch(cfg: PipelineConfig, step: int,
               dp_rank: int = 0) -> dict[str, Any]:
    """Build one host-local batch for (step, dp_rank)."""
    exec_style_of(cfg.strategy)          # unknown strategies fail fast
    rng = make_rng(hash((cfg.seed, dp_rank, step)) % (2 ** 63))
    doc_lens_list = [pack_sequence(cfg.dataset, cfg.context_len, rng)
                     for _ in range(cfg.batch_per_host)]
    cache = _plan_cache(cfg)
    plans = [cache.plan(lens) for lens in doc_lens_list]
    stack, encs = encode_plan_batch(plans, align=cfg.align)
    tokens, labels = _synthesize_tokens(doc_lens_list, stack["perm"], rng,
                                        cfg.vocab_size)
    batch = dict(stack)
    if cfg.emit_tables:
        batch.update(_emit_tables(cfg, stack, cfg.cp_size))
    batch["tokens"] = tokens
    batch["labels"] = labels
    batch["stats"] = _batch_stats(encs, doc_lens_list, cache)
    return batch


def data_iterator(cfg: PipelineConfig, start_step: int = 0,
                  dp_rank: int = 0) -> Iterator[dict[str, Any]]:
    """``make_batch(cfg, step, dp_rank)`` for step = start_step, ..."""
    step = start_step
    while True:
        yield make_batch(cfg, step, dp_rank)
        step += 1


class Prefetcher:
    """The batches of :func:`data_iterator`, built ahead on a background
    thread into a queue of ``prefetch`` batches.  A failure of the
    thread is raised by the ``next()`` that would have returned its
    batch; ``close()`` stops the thread and joins it."""

    _POLL_S = 0.1

    def __init__(self, cfg: PipelineConfig, start_step: int = 0,
                 dp_rank: int = 0, prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(cfg, start_step, dp_rank), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; whether it was queued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, cfg, start_step, dp_rank):
        try:
            for batch in data_iterator(cfg, start_step, dp_rank):
                if not self._put(batch):
                    return
        except Exception as err:  # noqa: BLE001 - handed to the consumer
            self._put(err)

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the prefetch thread failed") from item
        return item

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
