"""Everything the benchmark takes from the port (``repro_torch``, under
``src/`` of the checkout): the configuration it trains, the training
step, the batches its planner makes of the benchmark's rows, and the
call sites of its doc-attention kernels, which the trace reader
attributes kernels to.  No other module of the benchmark imports the
port; the reference imports none of it."""

from __future__ import annotations

import contextlib
import functools
import queue
import sys
import threading
import time

import numpy as np

from .manifest import ROOT

__all__ = ["import_port", "model_config", "run_config", "Feed", "Prefetch",
           "DOC_ATTN_SPAN", "mark_doc_attention", "to_tree", "flatten"]

#: the profiler range around every call of the port's doc-attention
#: kernel entry points
DOC_ATTN_SPAN = "cpbench.doc_attention"
#: the port's doc-attention kernel entry points (module, functions)
DOC_ATTN_ENTRIES = ("repro_torch.kernels.doc_attention",
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))


def import_port():
    """Put the checkout's ``src`` first on the path and import the port."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch  # noqa: F401
    return repro_torch


def model_config(spec, port_model: dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=spec.name, num_layers=spec.layers, d_model=spec.d_model,
        num_heads=spec.heads, num_kv_heads=spec.kv_heads, d_ff=spec.d_ff,
        vocab_size=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, norm_eps=spec.norm_eps,
        tie_embeddings=spec.tie, dtype=spec.train["dtype"], **port_model)


def run_config(spec, seed: int):
    from repro_torch.configs.base import RunConfig

    t = spec.train
    return RunConfig(
        arch=spec.name, cp_strategy=t["cp_strategy"],
        attention_impl=t["attention_impl"], cp_overlap=t["cp_overlap"],
        kernel_grid=t["kernel_grid"], lr=t["lr"],
        weight_decay=t["weight_decay"], warmup_steps=t["warmup_steps"],
        total_steps=t["total_steps"], grad_clip=t["grad_clip"],
        remat=t["remat"], seed=int(seed) % (1 << 63))


def check_optimizer(spec) -> None:
    """Refuse a recipe the port's AdamW and schedule do not run."""
    import inspect

    from repro_torch.optim import adamw_update, warmup_cosine

    kw = inspect.signature(adamw_update).parameters
    t = spec.train
    have = (kw["b1"].default, kw["b2"].default, kw["eps"].default,
            inspect.signature(warmup_cosine).parameters["min_ratio"].default)
    want = (*t["betas"], t["eps"], t["min_lr_ratio"])
    if have != tuple(want):
        raise ValueError(f"{spec.name}: the port's AdamW and schedule run "
                         f"{have}, the configuration states {want}")


def to_tree(flat: dict) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


class Feed:
    """The port's batch of one step's rows: its planner (through the
    registry and a plan cache), the Eq. 5 encoding and, for the kernels,
    the visit tables, as ``repro_torch.data.pipeline.make_batch`` makes
    them; the rows' tokens and labels placed in plan order by the plan's
    permutation."""

    def __init__(self, traffic, spec):
        from repro_torch.core.cp_attention import resolve_overlap
        from repro_torch.data.pipeline import PipelineConfig, exec_style_of
        from repro_torch.planner import PlanCache, get_planner

        t = spec.train
        self.traffic = traffic
        self.cp = t["mesh"]["model"]
        self.cfg = PipelineConfig(
            dataset="cpbench", context_len=traffic.context_len,
            batch_per_host=traffic.mix["rows"], cp_size=self.cp,
            strategy=t["cp_strategy"], vocab_size=spec.vocab,
            align=128 if t["attention_impl"] == "flash" else 16,
            emit_tables=t["attention_impl"] == "flash",
            table_overlap=t["cp_overlap"], table_grid=t["kernel_grid"])
        planner = get_planner(self.cfg.strategy)
        kwargs = {"target_ratio": self.cfg.target_imbalance} \
            if planner.info.supports_target_ratio else {}
        self.cache = PlanCache(planner, self.cp,
                               granularity=self.cfg.cache_granularity,
                               max_entries=self.cfg.cache_entries,
                               planner_kwargs=kwargs)
        self.style = exec_style_of(self.cfg.strategy)
        self.overlap = resolve_overlap(self.style, "flash",
                                       self.cfg.table_overlap)

    def batch(self, step: int) -> tuple[dict, list]:
        """(the port's numpy batch, the benchmark's rows) of ``step``.
        The batch's ``stats`` also hold ``plan_s``, the host seconds of
        the port's planner, Eq. 5 encoding and table emitter, and
        ``plan_hits``, the rows whose plan the cache held."""
        from repro_torch.planner import (emit_visit_tables, encode_plan_batch,
                                         plan_many)

        cfg, cs = self.cfg, self.cache.stats
        rows = self.traffic.rows(step)
        t0, hits = time.perf_counter(), cs.hits + cs.quantized_hits
        plans = plan_many(self.cache.plan, [r.doc_lens for r in rows],
                          workers=cfg.planner_workers)
        stack, encs = encode_plan_batch(plans, buf_len=cfg.buf_len,
                                        align=cfg.align)
        batch = dict(stack)
        if cfg.emit_tables:
            gath = self.style in ("flashcp", "contiguous")
            batch.update(emit_visit_tables(
                stack["doc"], stack["pos"],
                stack["gath_doc"] if gath else None,
                stack["gath_pos"] if gath else None,
                num_workers=self.cp, strategy=self.style,
                overlap=self.overlap, grid=cfg.table_grid,
                block_q=cfg.table_block_q, block_k=cfg.table_block_k))
        plan_s = time.perf_counter() - t0
        perm = stack["perm"]
        tokens = np.full(perm.shape, -1, np.int32)
        labels = np.full(perm.shape, -1, np.int32)
        for b, r in enumerate(rows):
            valid = perm[b] >= 0
            tokens[b][valid] = r.tokens[perm[b][valid]]
            labels[b][valid] = r.labels[perm[b][valid]]
        batch["tokens"] = tokens
        batch["labels"] = labels
        batch["stats"] = {"comm_tokens": max(e.comm_tokens for e in encs),
                          "imbalance": float(np.mean([e.imbalance
                                                      for e in encs])),
                          "plan_s": plan_s,
                          "plan_hits": cs.hits + cs.quantized_hits - hits}
        return batch, rows


class Prefetch:
    """:class:`Feed`'s batches from ``start`` on, built ahead on one
    background thread into a queue of ``depth``, as the port's
    ``Prefetcher`` builds its pipeline's; a failure of the thread is
    raised by the ``next()`` that would have returned its batch."""

    def __init__(self, feed: Feed, start: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        args=(feed, start), daemon=True)
        self._thread.start()

    def _run(self, feed, step):
        try:
            while not self._stop.is_set():
                item = feed.batch(step)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except Exception as err:  # noqa: BLE001 - handed to the consumer
            self._q.put(err)

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the batch thread failed") from item
        return item

    def close(self) -> None:
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()


@contextlib.contextmanager
def mark_doc_attention():
    """Inside, every call of the port's doc-attention kernel entry
    points runs under a profiler range named :data:`DOC_ATTN_SPAN`, on
    whatever thread calls it (the backward's too)."""
    import importlib

    import torch

    mod = importlib.import_module(DOC_ATTN_ENTRIES[0])
    saved = {name: getattr(mod, name) for name in DOC_ATTN_ENTRIES[1]}

    def wrap(fn):
        @functools.wraps(fn)    # the entry's attributes (its counters)
        def inner(*a, **kw):
            with torch.profiler.record_function(DOC_ATTN_SPAN):
                return fn(*a, **kw)
        return inner

    wrapped = {name: wrap(fn) for name, fn in saved.items()}
    for name, fn in wrapped.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            fn.__dict__.update(wrapped[name].__dict__)
            setattr(mod, name, fn)
