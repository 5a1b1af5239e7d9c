"""Serving resilience: bounded admission, fault quarantine, snapshots.

The port of the reference's ``repro.serve.resilience`` (DESIGN.md
§Serving-resilience):

* **Bounded admission with deadline-aware shedding** —
  :class:`AdmissionConfig` caps the queue and picks the overload
  policy: ``"fifo"`` sheds the *incoming* request when the queue is
  full, ``"deadline"`` sheds the queued-or-incoming request least
  likely to meet its deadline (lowest ``(priority, slack)``) and drops
  queued requests whose deadline became unmeetable.  ``lookahead`` lets
  up to that many requests jump a head that cannot be placed right now,
  under a starvation guard.
* **Fault quarantine** (:class:`Watchdog`) — planned-but-no-progress
  slots are aborted after ``stall_patience`` steps; the engine aborts
  requests with non-finite logits.  Per-request keyed sampling keeps
  the healthy requests' tokens unchanged.
* **Snapshot / drain-restore** (:func:`snapshot_engine` /
  :func:`restore_engine`) — the whole engine state (KV cache leaves,
  scheduler queue, slots and finished results, block pool refcounts and
  free list, prefix-cache trie in LRU order, stats) through the port's
  :class:`~repro_torch.checkpoint.CheckpointManager` (atomic commit,
  LATEST pointer), in the reference's layout.  A request's sampling
  cursor is its count of generated tokens (sampling is keyed on (seed,
  rid, count)), so a killed engine restores mid-decode with no request
  lost and the same tokens.

:class:`ChaosInjector` injects deterministic faults keyed on (rid, engine
step): NaN logits, stuck slots, latency spikes and a kill.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any

import numpy as np
import torch

__all__ = ["AdmissionConfig", "ChaosInjector", "EngineKilled", "Watchdog",
           "deadline_slack", "estimate_steps", "parse_chaos",
           "restore_engine", "shed_key", "snapshot_engine"]


# ------------------------------------------------------------------- #
# admission policy
# ------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Queue bound + overload policy for :class:`~.scheduler.Scheduler`.

    ``max_queue=0`` keeps the queue unbounded (the pre-resilience
    behavior).  ``lookahead=0`` is strict FIFO admission: a head that
    cannot be placed blocks everything behind it."""
    max_queue: int = 0
    policy: str = "fifo"            # "fifo" | "deadline"
    lookahead: int = 0              # requests that may jump a blocked head
    starvation_limit: int = 8       # head jumps before look-ahead pauses

    def __post_init__(self):
        if self.policy not in ("fifo", "deadline"):
            raise ValueError(f"unknown admission policy {self.policy!r}")


def estimate_steps(prompt_len: int, max_new: int, prefill_chunk: int) -> int:
    """Optimistic engine-step lower bound to serve a queued request:
    one step per prompt chunk (the final chunk also yields the first
    token) plus one decode step per remaining token.  Optimistic on
    purpose — shedding on it never sheds a request that could still
    have met its deadline under ideal scheduling."""
    chunks = -(-prompt_len // max(prefill_chunk, 1))
    return chunks + max(max_new - 1, 0)


def deadline_slack(req, clock: int, prefill_chunk: int) -> float:
    """Engine steps to spare before ``req``'s deadline becomes
    unmeetable even if admitted *now* (+inf when no deadline)."""
    if req.deadline_steps < 0:
        return math.inf
    due = req.submit_step + req.deadline_steps
    return due - clock - estimate_steps(req.prompt_len, req.max_new,
                                        prefill_chunk)


def shed_key(req, clock: int, prefill_chunk: int):
    """Shed order under overload: lowest priority first, then least
    slack, then newest arrival (highest rid) as the tie-break."""
    return (req.priority, deadline_slack(req, clock, prefill_chunk),
            -req.rid)


# ------------------------------------------------------------------- #
# fault quarantine
# ------------------------------------------------------------------- #
class Watchdog:
    """Per-slot no-progress detector.  A slot counts as *stalled* only
    on steps where the scheduler planned work for it (prefill chunk or
    decode token) and none landed — budget starvation and serial-mode
    waits plan nothing and so can never trip it.  ``stall_patience``
    consecutive stalled steps abort the slot's request."""

    def __init__(self, stall_patience: int = 8):
        self.stall_patience = stall_patience
        self._stalled: dict[int, int] = {}

    def observe(self, planned: set[int], progressed: set[int],
                ) -> list[tuple[int, int]]:
        """Returns ``[(slot, consecutive_stalled_steps)]`` for slots
        that just hit the patience limit."""
        out = []
        for s in planned:
            if s in progressed:
                self._stalled.pop(s, None)
                continue
            c = self._stalled.get(s, 0) + 1
            self._stalled[s] = c
            if c >= self.stall_patience:
                out.append((s, c))
        return out

    def clear(self, slot: int) -> None:
        self._stalled.pop(slot, None)


class EngineKilled(RuntimeError):
    """Raised by an injected kill (``ChaosInjector.kill_at``), the serving
    analogue of a host loss.  The CLI catches it, builds a fresh engine
    and restores the latest snapshot."""


@dataclasses.dataclass
class ChaosInjector:
    """Deterministic serve-path fault injection.  Every fault keys on the
    engine step counter, so a restored run does not fire again a fault it
    survived; ``kill_fired`` also makes the kill fire once per process.

    * ``nan_logits[rid] = step`` — from that step on, the request's decode
      and prefill logits rows are NaN (a corrupted KV page or a bad
      expert, as the sampler sees it).
    * ``stuck[rid] = step`` — from that step on, the request's planned
      work is dropped before it runs (a wedged device call).
    * ``delays[step] = seconds`` — a latency spike at one step.
    * ``kill_at`` — raise :class:`EngineKilled` entering that step.
    """
    nan_logits: dict[int, int] = dataclasses.field(default_factory=dict)
    stuck: dict[int, int] = dataclasses.field(default_factory=dict)
    delays: dict[int, float] = dataclasses.field(default_factory=dict)
    kill_at: int = -1
    kill_fired: bool = False

    def poisons(self, rid: int, step: int) -> bool:
        t = self.nan_logits.get(rid)
        return t is not None and step >= t

    def is_stuck(self, rid: int, step: int) -> bool:
        t = self.stuck.get(rid)
        return t is not None and step >= t

    def delay(self, step: int) -> float:
        return self.delays.get(step, 0.0)

    def maybe_kill(self, step: int) -> None:
        if self.kill_at >= 0 and step >= self.kill_at \
                and not self.kill_fired:
            self.kill_fired = True
            raise EngineKilled(f"injected engine kill at step {step}")


def parse_chaos(nan_specs=(), stuck_specs=(), delay_specs=(),
                kill_at: int = -1) -> ChaosInjector | None:
    """A :class:`ChaosInjector` from CLI specs: ``RID:STEP`` for NaN and
    stuck faults, ``STEP:SECONDS`` for latency spikes.  None when nothing
    is injected."""
    def pairs(specs):
        for spec in specs or ():
            a, b = str(spec).split(":")
            yield int(a), b
    nan = {r: int(s) for r, s in pairs(nan_specs)}
    stuck = {r: int(s) for r, s in pairs(stuck_specs)}
    delays = {st: float(sec) for st, sec in pairs(delay_specs)}
    if not (nan or stuck or delays or kill_at >= 0):
        return None
    return ChaosInjector(nan_logits=nan, stuck=stuck, delays=delays,
                         kill_at=kill_at)


# ------------------------------------------------------------------- #
# snapshot / restore
# ------------------------------------------------------------------- #
def _cache_leaves(cache) -> list[torch.Tensor]:
    """The KV leaves in sorted-key order (the reference's
    ``jax.tree.leaves`` order of the same dict tree)."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in _cache_leaves(cache[k])]
    return [cache]


def _engine_geometry(eng) -> dict:
    return {
        "arch": eng.cfg.name, "layout": eng.layout,
        "num_slots": eng.num_slots, "max_len": eng.max_len,
        "prefill_chunk": eng.prefill_chunk,
        "block_size": eng.block_size, "num_blocks": eng.num_blocks,
        "seed": eng._seed, "prefix_cache": eng.prefix is not None,
        "cache_leaves": len(_cache_leaves(eng.cache)),
    }


def _request_meta(req, now_s: float) -> dict:
    return {
        "rid": req.rid, "max_new": req.max_new,
        "temperature": req.temperature, "top_k": req.top_k,
        "eos_id": req.eos_id, "deadline_steps": req.deadline_steps,
        "priority": req.priority, "submit_step": req.submit_step,
        # perf_counter is not comparable across processes: persist the
        # elapsed wait and rebase it onto the restoring process's clock
        "waited_s": now_s - req.submit_s,
    }


def snapshot_engine(eng, directory: str) -> int:
    """Persist the engine mid-flight through ``CheckpointManager``
    (atomic commit, LATEST pointer, retention).  Everything a restored
    engine needs resumes exactly: KV cache leaves, queue and slot states
    (block tables, generated tokens = the sampling cursors), finished
    results, pool refcounts, prefix trie, stats.  Returns the snapshot's
    step id (the engine step counter)."""
    sc = eng.sched
    step = int(eng.stats["steps"])
    now_s = time.perf_counter()

    reqs = {r.rid: r for r in sc.queue}
    slots_meta = {}
    for s in sc.active_slots:
        st = sc.slots[s]
        reqs[st.request.rid] = st.request
        slots_meta[str(s)] = {
            "rid": st.request.rid, "prefilled": st.prefilled,
            "length": st.length,
            "generated": [int(t) for t in st.generated],
            "table": [int(b) for b in st.table],
            "cached_tokens": st.cached_tokens, "spare": st.spare,
        }

    state: dict[str, Any] = {
        "cache": {f"{i:05d}": leaf
                  for i, leaf in enumerate(_cache_leaves(eng.cache))},
    }
    if reqs:
        state["prompts"] = {str(rid): np.asarray(r.tokens, np.int32)
                            for rid, r in reqs.items()}
    frames = {str(rid): np.asarray(r.frames, np.float32)
              for rid, r in reqs.items() if r.frames is not None}
    if frames:
        state["frames"] = frames
    if sc.finished:
        state["fin_tokens"] = {
            str(rid): np.asarray(e["tokens"], np.int32)
            for rid, e in sc.finished.items()}

    extra = {
        "geometry": _engine_geometry(eng),
        "engine": {
            "next_rid": eng._next_rid,
            "stats": {k: v for k, v in eng.stats.items()
                      if not isinstance(v, dict)},
        },
        "scheduler": {
            "clock": sc.clock,
            "queue": [r.rid for r in sc.queue],
            "slots": slots_meta,
            "requests": {str(rid): _request_meta(r, now_s)
                         for rid, r in reqs.items()},
            "finished": {str(rid): {k: v for k, v in e.items()
                                    if k != "tokens"}
                         for rid, e in sc.finished.items()},
            "outcomes": sc.outcomes,
            "duplicates": sc.duplicates,
            "head_rid": sc._head_rid,
            "head_skips": sc._head_skips,
        },
        "pool": None if eng.pool is None else {
            "ref": [int(v) for v in eng.pool._ref],
            "free": [int(v) for v in eng.pool._free],
            "peak": int(eng.pool.peak_allocated),
        },
        "prefix": None if eng.prefix is None else {
            # nodes in LRU order (oldest first): replaying inserts in
            # this order rebuilds both the trie and the LRU list
            "nodes": [[int(eng.prefix._key_of[bid][0]),
                       [int(t) for t in eng.prefix._key_of[bid][1]],
                       int(bid)]
                      for bid in eng.prefix._lru],
            "hits": eng.prefix.hits, "misses": eng.prefix.misses,
        },
    }
    eng._snapshot_manager(directory).save(step, state, extra=extra,
                                          blocking=True)
    return step


def restore_engine(eng, directory: str, step: int | None = None) -> int:
    """Load a :func:`snapshot_engine` snapshot into a freshly built engine
    of the same geometry (arch, layout, slots, lengths, seed: anything
    else would change shapes or token streams) and resume from it.  The
    KV leaves are copied into the engine's own tensors, on its device.
    Returns the restored step."""
    from repro_torch.checkpoint import CheckpointManager
    from .scheduler import Request, SlotState

    snap_step, tree, manifest = CheckpointManager(directory).restore(step)
    x = manifest["extra"]
    mine, theirs = _engine_geometry(eng), x["geometry"]
    bad = {k: (theirs.get(k), mine[k]) for k in mine
           if mine[k] != theirs.get(k)}
    if bad:
        raise ValueError(
            f"snapshot geometry mismatch (snapshot vs engine): {bad}")

    saved = tree.get("cache", {})
    leaves = _cache_leaves(eng.cache)
    if len(saved) != len(leaves):
        raise ValueError(f"snapshot has {len(saved)} cache leaves, "
                         f"engine expects {len(leaves)}")
    for leaf, key in zip(leaves, sorted(saved)):
        leaf.copy_(saved[key].to(leaf.device))

    xs = x["scheduler"]
    prompts = tree.get("prompts", {})
    frame_arrays = tree.get("frames", {})
    now_s = time.perf_counter()

    def mk_request(meta: dict) -> Request:
        rid = int(meta["rid"])
        r = Request(
            rid=rid, tokens=prompts[str(rid)].numpy().astype(np.int32),
            max_new=int(meta["max_new"]),
            temperature=float(meta["temperature"]),
            top_k=int(meta["top_k"]), eos_id=int(meta["eos_id"]),
            frames=None if str(rid) not in frame_arrays
            else frame_arrays[str(rid)].numpy().astype(np.float32),
            deadline_steps=int(meta["deadline_steps"]),
            priority=int(meta["priority"]))
        r.submit_step = int(meta["submit_step"])
        r.submit_s = now_s - float(meta["waited_s"])
        return r

    sc = eng.sched
    req_meta = xs["requests"]
    sc.queue = deque(mk_request(req_meta[str(rid)])
                     for rid in xs["queue"])
    sc.slots = [None] * eng.num_slots
    for s_str, sm in xs["slots"].items():
        sc.slots[int(s_str)] = SlotState(
            request=mk_request(req_meta[str(sm["rid"])]),
            prefilled=int(sm["prefilled"]), length=int(sm["length"]),
            generated=[int(t) for t in sm["generated"]],
            table=[int(b) for b in sm["table"]],
            cached_tokens=int(sm["cached_tokens"]), spare=sm["spare"])
    fin_tokens = tree.get("fin_tokens", {})
    sc.finished = {}
    for rid_str, meta in xs["finished"].items():
        entry = dict(meta)
        toks = fin_tokens.get(rid_str)
        entry["tokens"] = np.zeros((0,), np.int32) if toks is None \
            else toks.numpy().astype(np.int32)
        sc.finished[int(rid_str)] = entry
    sc.clock = int(xs["clock"])
    sc._head_rid = xs["head_rid"]
    sc._head_skips = int(xs["head_skips"])
    sc.duplicates = list(xs.get("duplicates", []))
    for kind, counts in xs["outcomes"].items():
        # in place: engine.stats aliases these dicts
        sc.outcomes[kind].clear()
        sc.outcomes[kind].update(counts)

    if eng.pool is not None:
        p = x["pool"]
        eng.pool._ref = [int(v) for v in p["ref"]]
        eng.pool._free = [int(v) for v in p["free"]]
        eng.pool.peak_allocated = int(p["peak"])
    if eng.prefix is not None:
        px = x["prefix"]
        pc = eng.prefix
        pc._by_key.clear()
        pc._key_of.clear()
        pc._children.clear()
        pc._lru.clear()
        for parent, toks, bid in px["nodes"]:
            key = (int(parent), tuple(int(t) for t in toks))
            pc._by_key[key] = int(bid)
            pc._key_of[int(bid)] = key
            pc._children.setdefault(int(bid), 0)
            pc._lru.append(int(bid))
        for (parent, _toks) in pc._by_key:
            if parent in pc._children:
                pc._children[parent] += 1
        pc.hits, pc.misses = int(px["hits"]), int(px["misses"])

    eng._next_rid = int(x["engine"]["next_rid"])
    for k, v in x["engine"]["stats"].items():
        eng.stats[k] = v
    if eng.watchdog is not None:        # stall counters do not carry over
        eng.watchdog = Watchdog(eng.watchdog.stall_patience)
    return snap_step
