"""Deterministic, host-sharded training batches (the port of the
reference's ``repro.data.pipeline``).

Per batch, per packed sequence:
  1. draw document lengths from the dataset distribution (seeded);
  2. resolve the configured CP planner through the
     :mod:`repro_torch.planner` registry and plan the batch's sequences
     on the planner pool (:func:`~repro_torch.planner.parallel.plan_many`,
     ``planner_workers`` threads; results in row order), through a
     :class:`~repro_torch.planner.cache.PlanCache` unless
     ``cache_plans`` is off;
  3. encode the plans (permutation + Eq.-5 comm metadata,
     :func:`~repro_torch.planner.encode.encode_plan_batch`; the bucket
     is ``buf_len`` where fixed, else chosen per batch);
  4. synthesize tokens and next-token labels in *plan order*, and (for
     the kernels) emit the per-rank visit tables.

The stream for (seed, dp_rank, step) draws from the same seeded
``PCG64`` as the reference, in the same order, and plans through copies
of the same planners with the same knobs (``buf_len``, ``cache_plans``,
``cache_granularity``, ``cache_entries``, ``planner_workers``, the
reference's defaults), so batches match it bit for bit at any CP size.
The target imbalance is ``PipelineConfig.target_imbalance`` (the
straggler monitor tightens it).  :class:`Prefetcher` builds the stream
ahead on a background thread.

**Global dispatch** (:func:`make_dispatch_batch`, DESIGN.md §Dispatch):
one seeded pool of documents per global step, which the
:mod:`repro_torch.dispatch` dispatcher sizes CP groups for and
LPT-balances over them; rows come group-major, so the batch rows split
contiguously over the re-tiled mesh's group axis.  Rows are ragged (bins
keep documents whole): each carries its valid-token count in
``seq_tokens``, and padding stays masked (``labels == -1``).  Every rank
builds the same global batch, bit for bit as the reference does.
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
                                 encode_plan_batch, get_planner, plan_many)
from .distributions import make_rng
from .packing import pack_sequence, sample_doc_pool

__all__ = ["PipelineConfig", "make_batch", "make_dispatch_batch",
           "exec_style_of", "data_iterator", "dispatch_iterator",
           "Prefetcher"]

#: the dp_rank of the global-dispatch stream: real ranks are >= 0, so a
#: dispatch batch never draws a per-rank stream
DISPATCH_RANK = -1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataset: str = "wlb_llm"
    context_len: int = 131072
    batch_per_host: int = 1
    cp_size: int = 1
    strategy: str = "flashcp"
    vocab_size: int = 50304
    seed: int = 0
    buf_len: int | None = None   # fixed Eq.5 bucket (None -> per-batch)
    align: int = 128             # T_loc alignment (kernel block size)
    # the FlashCP heuristic's target max/mean load ratio (planners that
    # take one)
    target_imbalance: float = 1.05
    # planner knobs: the plan cache (1 = exact signatures, plan-identical
    # to no cache) and the planning threads (0 = auto)
    cache_plans: bool = True
    cache_granularity: int = 1
    cache_entries: int = 256
    planner_workers: int = 0
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
def _planner_state(cfg: PipelineConfig):
    """(planner, kwargs, cache or None) of a config, made once (configs
    that differ in CP size, strategy, target imbalance or cache knobs
    keep their own plans)."""
    planner = get_planner(cfg.strategy)
    kwargs = {}
    if planner.info.supports_target_ratio:
        kwargs["target_ratio"] = cfg.target_imbalance
    cache = PlanCache(planner, cfg.cp_size,
                      granularity=cfg.cache_granularity,
                      max_entries=cfg.cache_entries,
                      planner_kwargs=kwargs) if cfg.cache_plans else None
    return planner, kwargs, cache


def _plan_rows(cfg: PipelineConfig, doc_lens_list) -> list:
    """The plans of a batch's rows, in row order, on the planner pool."""
    planner, kwargs, cache = _planner_state(cfg)
    fn = cache.plan if cache is not None else \
        (lambda lens: planner(lens, cfg.cp_size, **kwargs))
    return plan_many(fn, doc_lens_list, workers=cfg.planner_workers)


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


def _synthesize_tokens(doc_lens_list, perm_stack, rngs,
                       vocab_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Batch token synthesis.  ``rngs`` is one shared Generator (the
    per-rank stream: rows draw in row order) or a list of per-row
    Generators (dispatch: each row's stream is keyed to its content, so
    tokens do not depend on the row order or the CP degree)."""
    B, C_pad = perm_stack.shape
    tokens = np.full((B, C_pad), -1, np.int32)
    labels = np.full((B, C_pad), -1, np.int32)
    for b, lens in enumerate(doc_lens_list):
        rng = rngs[b] if isinstance(rngs, list) else rngs
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


def _batch_stats(encs, doc_lens_list, cache: PlanCache | None) -> dict:
    return {
        "comm_tokens": max(e.comm_tokens for e in encs),
        "buf_len": encs[0].buf_len,
        "t_loc": encs[0].t_loc,
        "imbalance": float(np.mean([e.imbalance for e in encs])),
        "num_docs": float(np.mean([len(l) for l in doc_lens_list])),
        "plan_cache_hit_rate":
            cache.stats.hit_rate if cache is not None else 0.0,
    }


def make_batch(cfg: PipelineConfig, step: int,
               dp_rank: int = 0) -> dict[str, Any]:
    """Build one host-local batch for (step, dp_rank)."""
    exec_style_of(cfg.strategy)          # unknown strategies fail fast
    rng = make_rng(hash((cfg.seed, dp_rank, step)) % (2 ** 63))
    doc_lens_list = [pack_sequence(cfg.dataset, cfg.context_len, rng)
                     for _ in range(cfg.batch_per_host)]
    plans = _plan_rows(cfg, doc_lens_list)
    stack, encs = encode_plan_batch(plans, buf_len=cfg.buf_len,
                                    align=cfg.align)
    tokens, labels = _synthesize_tokens(doc_lens_list, stack["perm"], rng,
                                        cfg.vocab_size)
    batch = dict(stack)
    if cfg.emit_tables:
        batch.update(_emit_tables(cfg, stack, cfg.cp_size))
    batch["tokens"] = tokens
    batch["labels"] = labels
    batch["stats"] = _batch_stats(encs, doc_lens_list,
                                  _planner_state(cfg)[2])
    return batch


def make_dispatch_batch(cfg: PipelineConfig, dcfg, step: int,
                        device_speeds=None) -> dict[str, Any]:
    """One *global* batch through the adaptive DP x CP dispatcher.

    One seeded document pool per step (every rank draws the same), sized
    and placed by :func:`repro_torch.dispatch.dispatch_step`: the CP
    degree follows the pool's length profile, rows come group-major (row
    ``r`` belongs to group ``r // seqs_per_group`` of the re-tiled mesh),
    and each row plans and encodes through the registry at the chosen
    degree.  ``t_loc`` is pinned to ``C / cp``, so a degree keeps one
    shape however ragged its bins; ``cfg.cp_size`` is not read.

    Beyond :func:`make_batch`'s keys: ``seq_tokens`` (per-row valid
    tokens), ``group_id`` (per-row group) and ``stats["dispatch"]`` (the
    decision, imbalances, candidates and pool profile).
    ``device_speeds`` (length ``data * model``, from the straggler
    monitor) makes the dispatcher balance completion time, with bins
    sized to each group's speed; the row streams are content-keyed, so
    only the placement moves."""
    from repro_torch.dispatch import dispatch_step

    exec_style_of(cfg.strategy)
    rng = make_rng(hash((cfg.seed, DISPATCH_RANK, step)) % (2 ** 63))
    pool = sample_doc_pool(cfg.dataset, dcfg.seqs * cfg.context_len, rng,
                           max_doc_len=cfg.context_len, min_docs=dcfg.seqs)
    dplan = dispatch_step(pool, dcfg, cfg.context_len,
                          device_speeds=device_speeds)
    g = dplan.cp_degree
    if not all(len(r) for r in dplan.rows):
        raise ValueError("dispatch made an empty sequence bin (the pool "
                         "is too small for the batch)")
    gcfg = dataclasses.replace(cfg, cp_size=g)
    plans = _plan_rows(gcfg, dplan.rows)
    stack, encs = encode_plan_batch(plans, buf_len=cfg.buf_len,
                                    t_loc=cfg.context_len // g,
                                    align=cfg.align)
    # per-row streams keyed to the row's pool documents (int tuples hash
    # the same in every process)
    row_rngs = [make_rng(hash((cfg.seed, DISPATCH_RANK, step)
                              + tuple(int(i) for i in docs)) % (2 ** 63))
                for docs in dplan.row_docs]
    tokens, labels = _synthesize_tokens(dplan.rows, stack["perm"],
                                        row_rngs, cfg.vocab_size)
    batch = dict(stack)
    if cfg.emit_tables:
        batch.update(_emit_tables(cfg, stack, g))
    batch["tokens"] = tokens
    batch["labels"] = labels
    batch["seq_tokens"] = np.asarray([int(r.sum()) for r in dplan.rows],
                                     np.int32)
    batch["group_id"] = dplan.group_of_row.astype(np.int32)
    batch["stats"] = _batch_stats(encs, dplan.rows, _planner_state(gcfg)[2])
    batch["stats"]["dispatch"] = {**dplan.stats(),
                                  "profile": dplan.profile.as_dict()}
    return batch


def data_iterator(cfg: PipelineConfig, start_step: int = 0,
                  dp_rank: int = 0) -> Iterator[dict[str, Any]]:
    """``make_batch(cfg, step, dp_rank)`` for step = start_step, ..."""
    step = start_step
    while True:
        yield make_batch(cfg, step, dp_rank)
        step += 1


def dispatch_iterator(cfg: PipelineConfig, dcfg, start_step: int = 0,
                      speeds_fn=None) -> Iterator[dict[str, Any]]:
    """``make_dispatch_batch`` for step = start_step, ...; ``speeds_fn``
    (no arguments, returns the device speeds or None) is sampled once a
    batch."""
    step = start_step
    while True:
        speeds = speeds_fn() if speeds_fn is not None else None
        yield make_dispatch_batch(cfg, dcfg, step, device_speeds=speeds)
        step += 1


class Prefetcher:
    """The batches of :func:`data_iterator` (or, given ``dispatch``, a
    ``DispatchConfig``, of :func:`dispatch_iterator` with ``speeds_fn``;
    ``dp_rank`` is then not read), built ahead on a background thread
    into a queue of ``prefetch`` batches.  A failure of the thread is
    raised by the ``next()`` that would have returned its batch;
    ``close()`` stops the thread and joins it."""

    _POLL_S = 0.1

    def __init__(self, cfg: PipelineConfig, start_step: int = 0,
                 dp_rank: int = 0, prefetch: int = 2, dispatch=None,
                 speeds_fn=None):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        it = dispatch_iterator(cfg, dispatch, start_step, speeds_fn) \
            if dispatch is not None else \
            data_iterator(cfg, start_step, dp_rank)
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
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

    def _run(self, it):
        try:
            for batch in it:
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
