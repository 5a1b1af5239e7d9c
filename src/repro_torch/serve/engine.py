"""Continuous-batching serving engine over a paged KV block pool.

The PyTorch port of the reference engine (DESIGN.md §7).  KV layouts
(``kv_layout``):

* **paged** (default) — one global pool of ``num_blocks`` x
  ``block_size`` token positions per attention sub-layer; each request
  holds a block table mapping logical to physical blocks
  (``block_pool.BlockPool`` does the host-side accounting).  Identical
  prompt prefixes share blocks through ``prefix.PrefixCache``, written
  once, refcounted, copied on write when a shared block must be
  appended.  Decode runs the ``flash_decode_paged`` kernel.
* **dense** — per-slot stripes, the parity oracle: paged and dense
  greedy decodes agree.  Decode runs ``flash_decode`` in partial mode
  and finalizes on the online-LSE merge substrate; ``attn_shards`` N
  splits each stripe into N segments, one partial each, LSE-merged
  (``flash_decode_sharded``).  The recurrent stacks (Jamba, xLSTM) keep
  this layout: their per-slot scan states have no block structure.

Attention-only stacks prefill in cache-writing chunks.  A recurrent
stack has no such prefill (its scan states would have to come out of
the training scan), so at admission it **replays** the prompt through
the decode step one token at a time, the updates written to the
admitted slot's row only, as the reference does.  The replay starts
from a zeroed row: the reference's carries the previous request's
recurrent state into a reused slot, which changes that request's tokens
(ROADMAP.md, Queue 3, F3).

The audio family's prompts carry their own frame embeddings
(``submit(frames=)``): they prefill from those frames, and each decode
step feeds zero frames (the stubbed codec frontend has no embedder for
generated tokens), as the reference does.  The VLM family prefills with
zero patches under an all-false mask, so its prompts are tokens.  A
request that carries frames matches no prefix-cache blocks and inserts
none: its KV comes from its frames, which the token trie does not see.
The reference's trie matches such prompts on token ids alone and shares
KV between prompts whose frames differ (ROADMAP.md, Queue 3, F5).

Each :meth:`step` spends one token budget (``scheduler.plan_step``):
decode-ready slots get their decode token first, the remainder buys
prompt chunks, so a long prompt prefills alongside in-flight decodes.
``unified=False`` restores serial prefill-then-decode as the stall
baseline.  Every request samples from its own ``(seed, rid,
n_generated)`` stream (``sampling``), so a dense model's results do not
depend on batch composition.  A MoE model's do: as in the reference,
decode routes all B slot rows, idle ones included, at the config's
capacity factor, so rows compete for expert slots and a request's tokens
depend on the other rows (a chaos abort can change a healthy MoE
request's tokens).  Admission is bounded and deadline-aware, and a watchdog
aborts requests with non-finite logits or stalled slots
(DESIGN.md §Serving-resilience): the decode step NaNs the rows a
:class:`~.resilience.ChaosInjector` poisons after the forward and before
the sampler, so the healthy rows keep their logits bit for bit and the
host quarantines the poisoned ones from the per-row finite mask.
:meth:`snapshot` / :meth:`restore_snapshot` persist the whole engine
mid-decode through the checkpoint manager's atomic commit; a killed
engine restores with no request lost and the same tokens.

Where the reference donates its cache buffers to jitted programs, this
engine owns its KV tensors and every program updates them in place.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import (decode_step, init_cache, init_paged_cache,
                                init_params, prefill_forward,
                                supports_cached_prefill, supports_paged_cache)
from .block_pool import BlockPool
from .prefix import PrefixCache
from .resilience import (AdmissionConfig, ChaosInjector, Watchdog,
                         restore_engine, snapshot_engine)
from .sampling import sample_tokens_keyed
from .scheduler import Request, Scheduler, SlotState

__all__ = ["ServeEngine"]


class ServeEngine:
    """Drive requests through budgeted prefill + continuous decode.

    ``device`` is "cuda" by default and raises without a card; pass
    "cpu" to run the plain PyTorch path.  ``params`` are the model's
    parameters on that device (``models.convert.params_from_numpy``
    converts the JAX package's), or None for a random init from
    ``seed``.  ``kv_layout`` "auto"/"paged" or "dense";
    ``block_size`` tokens per KV block; ``num_blocks`` pool size (0 =
    ``num_slots * ceil(max_len / block_size)``); ``token_budget`` tokens
    per step (0 = ``num_slots + prefill_chunk``); ``prefix_cache``
    shares identical prompt prefixes (paged only); ``unified=False``
    serializes prefill before decode.  ``decode_impl`` "flash" (the
    kernels) or "dense" (the softmax oracle).  ``attn_shards`` splits
    the dense decode cache into that many LSE-merged segments; it is a
    dense-layout feature, so "auto" then picks dense and "paged" is
    refused.  "auto" picks dense for a recurrent stack too, and "paged"
    is refused there.

    Resilience: ``max_queue`` bounds the queue (0 = unbounded),
    ``admission`` picks the overload policy ("fifo" or "deadline"),
    ``admit_lookahead`` lets placeable requests jump a pool-blocked
    head under ``starvation_limit``; ``watchdog=False`` disables fault
    quarantine; ``stall_patience`` is the planned-but-no-progress steps
    before a slot aborts; ``chaos`` takes a
    :class:`~.resilience.ChaosInjector`.
    """

    def __init__(self, cfg: ModelConfig, params=None, *,
                 device: str | torch.device = "cuda", num_slots: int = 4,
                 max_len: int = 256, prefill_chunk: int = 64,
                 decode_impl: str = "flash", attn_shards: int = 1,
                 seed: int = 0, kv_layout: str = "auto", block_size: int = 16,
                 num_blocks: int = 0, token_budget: int = 0,
                 prefix_cache: bool = True, unified: bool = True,
                 max_queue: int = 0, admission: str = "fifo",
                 admit_lookahead: int = 4, starvation_limit: int = 8,
                 watchdog: bool = True, stall_patience: int = 8,
                 chaos: ChaosInjector | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.prefill_chunk = min(prefill_chunk, max_len)
        if decode_impl not in ("flash", "dense"):
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        self.decode_impl = decode_impl
        self.cached_prefill = supports_cached_prefill(cfg)
        if kv_layout == "auto":
            # paged where the arch can (attention-only mixers); sharded
            # decode (LSE-merged stripe segments) is a dense-layout
            # feature
            kv_layout = "paged" if supports_paged_cache(cfg) \
                and attn_shards == 1 else "dense"
        elif kv_layout == "paged" and not supports_paged_cache(cfg):
            raise ValueError(
                f"{cfg.name}: paged KV requires attention-only mixers "
                "(recurrent scan states have no block structure)")
        elif kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "paged" and attn_shards > 1:
            raise ValueError("attn_shards>1 is a dense-layout feature "
                             "(LSE-merged stripe segments)")
        self.layout = kv_layout
        self.attn_shards = attn_shards

        self.params = init_params(cfg, seed=seed, device=self.device) \
            if params is None else params

        self.block_size = block_size
        self._nk = -(-max_len // block_size)     # table width in blocks
        if kv_layout == "paged":
            self.num_blocks = num_blocks or num_slots * self._nk
            self.pool = BlockPool(self.num_blocks, block_size)
            self.prefix = PrefixCache(block_size) if prefix_cache else None
            self.cache = init_paged_cache(cfg, self.num_blocks, block_size,
                                          device=self.device)
        else:
            self.num_blocks = 0
            self.pool = None
            self.prefix = None
            self.cache = init_cache(cfg, num_slots, max_len,
                                    device=self.device)

        self.sched = Scheduler(
            num_slots, max_len, prefill_chunk=self.prefill_chunk,
            token_budget=token_budget, unified=unified,
            admission=AdmissionConfig(
                max_queue=max_queue, policy=admission,
                lookahead=admit_lookahead,
                starvation_limit=starvation_limit))
        self.sched.on_retire = self._on_retire
        self.watchdog = Watchdog(stall_patience) if watchdog else None
        self.chaos = chaos
        self._seed = seed
        self._snap_mgrs: dict[str, Any] = {}
        self._next_rid = 0
        self.stats: dict[str, Any] = {
            "prefill_tokens": 0, "prefill_chunk_tokens": 0,
            "prefill_cached_tokens": 0, "prefill_steps": 0,
            "prefill_decode_steps": 0, "prefill_s": 0.0,
            "decode_tokens": 0, "decode_steps": 0, "decode_s": 0.0,
            "admitted": 0, "retired": 0, "steps": 0,
            "stalled_decode_steps": 0, "cow_copies": 0,
            "admission_backoffs": 0,
            "pool_block_steps": 0, "live_token_steps": 0,
            "chaos_delay_s": 0.0, "snapshots": 0,
            # reason-keyed terminal counters, aliased from the
            # scheduler (single source; mutated in place)
            "rejected_by_reason": self.sched.outcomes["rejected"],
            "shed_by_reason": self.sched.outcomes["shed"],
            "aborted_by_reason": self.sched.outcomes["aborted"]}

    # ------------------------------------------------------------- #
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def _sync(self) -> None:
        """Wait for the device, so host-clock spans cover its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _view_bucket(self, end: int) -> int:
        """pow2 cache-view bucket covering prefix ``end`` (tokens), in
        this layout's view unit: blocks (paged) or tokens (dense).
        Prefill attention then costs O(C * view), not O(C * max_len)."""
        if self.layout == "paged":
            v = 1
            while v * self.block_size < end:
                v *= 2
            return min(v, self._nk)
        s = self.prefill_chunk
        while s < end:
            s *= 2
        return min(s, self.max_len)

    # ------------------------------------------------------------- #
    def submit(self, tokens, *, max_new: int = 16, temperature: float = 0.0,
               top_k: int = 0, eos_id: int = -1, frames=None,
               deadline_steps: int = -1, priority: int = 0) -> int:
        """Queue one request; returns its request id.  Oversized
        requests land in the results with status "rejected", overload
        victims (bounded queue) with status "shed".  ``frames`` (Tp,
        d_model): an audio prompt's frame embeddings (its ``tokens``
        then only count and key it).  ``deadline_steps`` is the
        engine-step budget the request must finish within (-1 = none);
        lower ``priority`` sheds first."""
        rid = self._next_rid
        self._next_rid += 1
        self.sched.clock = self.stats["steps"]
        self.sched.submit(Request(
            rid=rid, tokens=np.asarray(tokens, np.int32), max_new=max_new,
            temperature=temperature, top_k=top_k, eos_id=eos_id,
            frames=None if frames is None
            else np.asarray(frames, np.float32),
            deadline_steps=deadline_steps, priority=priority))
        return rid

    # ------------------------------------------------------------- #
    # paged block accounting (host side)
    def _place(self, req: Request) -> dict | None:
        """Reserve KV for one request at admission.  Paged: match the
        prefix cache, then allocate the remaining blocks all-or-nothing
        (evicting unreferenced cached blocks if short); None = backoff,
        the request stays queued."""
        if self.layout != "paged":
            return {}
        bs = self.block_size
        Tp, mn = req.prompt_len, req.max_new
        # a prompt of frames shares nothing: the trie keys token ids
        matched = [] if self.prefix is None or req.frames is not None \
            else self.prefix.match(req.tokens)
        nk_req = -(-(Tp + mn - 1) // bs)
        while True:
            m = len(matched) * bs
            # a fully-cached prompt still recomputes its final token (its
            # logits seed sampling): reserve the copy-on-write spare for
            # the shared block that write lands in
            start = min(m, Tp - 1)
            n_fresh = nk_req - len(matched)
            n_spare = 1 if m >= Tp else 0
            need = n_fresh + n_spare
            # retain the matched chain BEFORE evicting, so the LRU sweep
            # (refcount == 1 only) cannot free blocks this request is
            # about to read
            self.pool.retain(matched)
            if self.prefix is not None and self.pool.free_count < need:
                self.prefix.evict(need - self.pool.free_count, self.pool)
            got = self.pool.alloc(need)
            if got is not None:
                break
            self.pool.release(matched)
            if not matched:
                self.stats["admission_backoffs"] += 1
                return None
            # retry with a shorter match: trade cached tokens for fit
            matched.pop()
        self.stats["prefill_cached_tokens"] += m
        return {"table": matched + got[:n_fresh], "cached": m,
                "start": start, "spare": got[n_fresh] if n_spare else None}

    def _on_retire(self, slot: int, st: SlotState) -> None:
        self.stats["retired"] += 1
        if self.watchdog is not None:
            self.watchdog.clear(slot)
        if self.layout == "paged":
            self.pool.release(st.table)
            if st.spare is not None:
                self.pool.release([st.spare])

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: clone pool block ``src`` into ``dst`` in place
        in every paged leaf (P, Hkv, NB * bs, hd)."""
        bs = self.block_size
        for sub in self.cache.values():
            for leaf in sub.values():
                leaf[:, :, dst * bs:(dst + 1) * bs] = \
                    leaf[:, :, src * bs:(src + 1) * bs]

    def _ensure_private(self, st: SlotState, bi: int) -> None:
        """Copy-on-write logical block ``bi`` of this request's table if
        it is shared (prefix-cached with other readers)."""
        if bi >= len(st.table):
            return
        bid = st.table[bi]
        if not self.pool.is_shared(bid):
            return
        if st.spare is not None:
            nb, st.spare = st.spare, None
        else:
            got = self.pool.alloc(1)
            if got is None:
                raise RuntimeError("copy-on-write with exhausted pool")
            nb = got[0]
        self._copy_block(bid, nb)
        self.pool.release([bid])
        st.table[bi] = nb
        self.stats["cow_copies"] += 1

    def block_tables(self) -> tuple[dict, dict]:
        """The live requests' block state, read-only, as the verifier's
        SRV rules take it (``repro_torch.analysis.plan_check.
        check_serve_state``): ``({request id: block-id table}, {block:
        references held outside the tables})`` — the copy-on-write
        spares.  Both empty on the dense layout, which has no pool."""
        tables, extra = {}, {}
        if self.layout != "paged":
            return tables, extra
        for s in self.sched.active_slots:
            st = self.sched.slots[s]
            tables[st.request.rid] = list(st.table)
            if st.spare is not None:
                extra[st.spare] = extra.get(st.spare, 0) + 1
        return tables, extra

    def _tables_matrix(self) -> np.ndarray:
        tab = np.zeros((self.num_slots, self._nk), np.int32)
        for s in self.sched.active_slots:
            t = self.sched.slots[s].table
            tab[s, :len(t)] = t
        return tab

    # ------------------------------------------------------------- #
    def _first_token(self, req: Request, logits_row) -> int:
        """Sample a request's first token (count 0 of its stream)."""
        tok = sample_tokens_keyed(self._seed, [req.rid], [0],
                                  logits_row[None].float(),
                                  [req.temperature], [req.top_k])
        return int(tok[0])

    def _chunk_batch(self, toks, frames) -> dict:
        """A prefill chunk's model inputs: the audio family's frames (1,
        C, d), or tokens (the VLM family's with zero patches under an
        all-false mask)."""
        if self.cfg.frontend == "audio_frames":
            return {"frame_embeds": frames}
        batch = {"tokens": toks}
        if self.cfg.frontend == "vit_patches":
            batch["patch_embeds"] = torch.zeros(
                (*toks.shape, self.cfg.d_model), device=self.device)
            batch["patch_mask"] = torch.zeros(toks.shape, dtype=torch.bool,
                                              device=self.device)
        return batch

    def _prefill(self, slot: int, toks, pos, active, with_logits: bool,
                 view: int, frames=None):
        """One prefill chunk through the model, cache written in place."""
        batch = self._chunk_batch(toks, frames)
        if self.layout == "paged":
            table = self._tensor(self._tables_matrix()[slot][None])
            return prefill_forward(
                self.params, self.cfg, self.cache, batch, pos, active,
                with_logits=with_logits, block_tables=table,
                block_size=self.block_size, view_blocks=view)[0]
        # dense: this slot's stripe, cropped to the view bucket (views,
        # so the prefill writes land in the engine's cache)
        crop = {j: {n: leaf[:, slot:slot + 1, :, :view]
                    for n, leaf in sub.items()}
                for j, sub in self.cache.items()}
        return prefill_forward(self.params, self.cfg, crop, batch, pos,
                               active, with_logits=with_logits)[0]

    def _run_prefill_chunk(self, slot: int, start: int, n: int) -> bool:
        """Prefill prompt tokens [start, start+n) of one slot; on the
        final chunk, sample the first token and start decoding.  Returns
        False when the slot was aborted (non-finite final logits; the
        request's blocks never reach the prefix cache)."""
        sc = self.sched
        st = sc.slots[slot]
        req = st.request
        C = self.prefill_chunk
        Tp = req.prompt_len
        t0 = time.perf_counter()
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = req.tokens[start:start + n]
        frames = None
        if self.cfg.frontend == "audio_frames":
            frames = np.zeros((1, C, self.cfg.d_model), np.float32)
            if req.frames is not None:
                frames[0, :n] = req.frames[start:start + n]
            frames = self._tensor(frames)
        pos = np.arange(start, start + C, dtype=np.int32)[None]
        active = (np.arange(C) < n)[None]
        with_logits = start + n >= Tp
        if self.layout == "paged":
            # only this chunk's first block can be prefix-shared (later
            # blocks are freshly allocated): copy it before writing
            self._ensure_private(st, start // self.block_size)
        logits = self._prefill(slot, self._tensor(toks, torch.long),
                               self._tensor(pos), self._tensor(active),
                               with_logits, self._view_bucket(start + C),
                               frames)
        self._sync()
        sc.note_prefill(slot, n)
        self.stats["prefill_steps"] += 1
        self.stats["prefill_chunk_tokens"] += n
        if with_logits:
            row = logits[0, n - 1].float()
            if self._poisoned(req.rid):
                row = torch.full_like(row, float("nan"))
            if self.watchdog is not None \
                    and not bool(torch.isfinite(row).all()):
                self.stats["prefill_s"] += time.perf_counter() - t0
                sc.abort(slot, "non-finite prefill logits at step "
                         f"{self.stats['steps']}", kind="nan_logits")
                return False
            if self.layout == "paged" and self.prefix is not None \
                    and req.frames is None:
                nfull = Tp // self.block_size
                if nfull:
                    self.prefix.insert(req.tokens[:nfull * self.block_size],
                                       st.table[:nfull], self.pool)
            first = self._first_token(req, row)
            self.stats["prefill_tokens"] += Tp
            sc.start(slot, first)
        self.stats["prefill_s"] += time.perf_counter() - t0
        return True

    def _prefill_replay(self, slot: int, req: Request) -> bool:
        """The recurrent stacks' prefill (dense layout): the whole prompt
        through the decode step one token at a time at admission, cache
        writes restricted to this slot's row (the other rows ride along,
        as in the reference, so a MoE layer routes them too).  The
        slot's row starts zeroed.  Returns False when the slot was
        aborted (non-finite final logits)."""
        t0 = time.perf_counter()
        B = self.num_slots
        for sub in self.cache.values():
            for leaf in sub.values():
                leaf[:, slot].zero_()
        onehot = np.zeros((B,), bool)
        onehot[slot] = True
        mask = self._tensor(onehot)
        tok = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int32)
        frames = np.zeros((B, self.cfg.d_model), np.float32)
        logits = None
        for t in range(req.prompt_len):
            tok[slot], pos[slot] = req.tokens[t], t
            if req.frames is not None:
                frames[slot] = req.frames[t]
            logits = self._decode(self._tensor(tok), self._tensor(pos), mask,
                                  None, self._tensor(frames))
            self.stats["prefill_decode_steps"] += 1
        row = logits[slot]
        if self._poisoned(req.rid):
            row = torch.full_like(row, float("nan"))
        self._sync()
        self.stats["prefill_tokens"] += req.prompt_len
        self.stats["prefill_chunk_tokens"] += req.prompt_len
        self.stats["prefill_s"] += time.perf_counter() - t0
        if self.watchdog is not None and not bool(torch.isfinite(row).all()):
            self.sched.abort(slot, "non-finite prefill logits at step "
                             f"{self.stats['steps']}", kind="nan_logits")
            return False
        self.sched.start(slot, self._first_token(req, row))
        return True

    # ------------------------------------------------------------- #
    def _poisoned(self, rid: int) -> bool:
        return self.chaos is not None \
            and self.chaos.poisons(rid, self.stats["steps"])

    def _decode(self, tok, lengths, dmask, poison, frames=None):
        """One batched decode step; returns (B, vocab) fp32 logits, NaN on
        the ``poison`` rows (chaos lands after the forward, before the
        sampler: a corrupted KV page as the sampler sees it; None: no
        row).  The audio family reads ``frames`` (B, d), zeros when None
        (a generated step has no frame embedder)."""
        kw = {"attn_impl": self.decode_impl, "write_mask": dmask}
        if self.layout == "paged":
            kw.update(block_tables=self._tensor(self._tables_matrix()),
                      block_size=self.block_size)
        else:
            kw.update(attn_shards=self.attn_shards)
        if self.cfg.frontend == "audio_frames":
            if frames is None:
                frames = torch.zeros((tok.shape[0], self.cfg.d_model),
                                     device=self.device)
            batch = {"frame_embeds": frames}
        else:
            batch = {"tokens": tok}
        logits, _ = decode_step(self.params, self.cfg, self.cache, batch,
                                lengths, **kw)
        if poison is None:
            return logits.float()
        return torch.where(poison[:, None], float("nan"), logits.float())

    def _decode_once(self, decode_slots: list[int]) -> list[int]:
        """One batched decode step; rows with non-finite logits are
        quarantined, only healthy slots record their token.  Returns
        the healthy slots."""
        sc = self.sched
        B = self.num_slots
        dmask = np.zeros((B,), bool)
        dmask[decode_slots] = True
        tok = np.zeros((B,), np.int64)
        poison = np.zeros((B,), bool)
        for s in decode_slots:
            tok[s] = sc.slots[s].generated[-1]
            poison[s] = self._poisoned(sc.slots[s].request.rid)
        lengths = np.where(dmask, sc.lengths(), 0).astype(np.int32)
        t0 = time.perf_counter()
        if self.layout == "paged":
            # safety net: a decode write must never land in a shared block
            for s in decode_slots:
                self._ensure_private(
                    sc.slots[s], sc.slots[s].length // self.block_size)
        logits = self._decode(self._tensor(tok), self._tensor(lengths),
                              self._tensor(dmask), self._tensor(poison))
        finite = torch.isfinite(logits).all(dim=-1).cpu().numpy()
        nxt = sample_tokens_keyed(self._seed, sc.rids(), sc.sample_counts(),
                                  logits, sc.temperatures(), sc.top_ks())
        nxt = nxt.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        if self.watchdog is None:
            healthy = list(decode_slots)
        else:
            healthy = [s for s in decode_slots if finite[s]]
            for s in decode_slots:
                if not finite[s]:
                    sc.abort(s, "non-finite decode logits at step "
                             f"{self.stats['steps']}", kind="nan_logits")
        self.stats["decode_tokens"] += len(healthy)
        sc.record(nxt, healthy)
        return healthy

    # ------------------------------------------------------------- #
    def step(self) -> bool:
        """One engine step: admit what fits, spend the token budget on
        prefill chunks + decode tokens, then run the watchdog.  Returns
        False when idle."""
        sc = self.sched
        step_no = self.stats["steps"]
        sc.clock = step_no
        if self.chaos is not None:
            self.chaos.maybe_kill(step_no)
            d = self.chaos.delay(step_no)
            if d > 0:
                time.sleep(d)
                self.stats["chaos_delay_s"] += d
        placed = sc.admit(self._place)
        self.stats["admitted"] += len(placed)
        if not self.cached_prefill:
            for slot, req in placed:
                self._prefill_replay(slot, req)
        if sc.queue and not placed and not sc.active_slots:
            # the head backed off even into an idle engine (its block
            # working set exceeds the pool after full prefix-cache
            # eviction): reject it instead of wedging the loop
            req = sc.queue.popleft()
            nk = -(-(req.prompt_len + req.max_new - 1) // self.block_size)
            sc.reject(req, f"working set of {nk} KV blocks exceeds the "
                      f"{self.num_blocks}-block pool",
                      kind="pool_unplaceable")
        n_ready = sum(1 for s in sc.active_slots
                      if sc.slots[s].decode_ready)
        prefill_items, decode_slots = sc.plan_step()
        planned = {s for s, _, _ in prefill_items} | set(decode_slots)
        if self.chaos is not None:
            # a stuck slot's planned work is dropped before it runs (a
            # wedged device call): the watchdog must catch it
            def _stuck(s):
                return self.chaos.is_stuck(sc.slots[s].request.rid,
                                           step_no)
            prefill_items = [it for it in prefill_items
                             if not _stuck(it[0])]
            decode_slots = [s for s in decode_slots if not _stuck(s)]
        progressed: set[int] = set()
        for slot, start, n in prefill_items:
            if self._run_prefill_chunk(slot, start, n):
                progressed.add(slot)
            else:
                planned.discard(slot)       # aborted, not stalled
        if decode_slots:
            healthy = self._decode_once(decode_slots)
            progressed |= set(healthy)
            planned -= set(decode_slots) - set(healthy)
        elif n_ready:
            # decode-ready slots got no token this step (serial mode
            # draining a long prefill): the stall the unified budget
            # eliminates
            self.stats["stalled_decode_steps"] += 1
        if self.watchdog is not None:
            for slot, n_stalled in self.watchdog.observe(planned,
                                                         progressed):
                sc.abort(slot, f"no scheduler progress for {n_stalled} "
                         f"planned steps (stuck slot {slot})",
                         kind="stall")
        self.stats["steps"] += 1
        self.stats["live_token_steps"] += sum(
            sc.slots[s].length for s in sc.active_slots)
        if self.layout == "paged":
            self.stats["pool_block_steps"] += self.pool.allocated_count
        return sc.has_work

    def run(self, max_steps: int = 100_000, *, snapshot_every: int = 0,
            snapshot_dir: str | None = None, drain_at: int = -1,
            ) -> dict[int, dict[str, Any]]:
        """Drain the queue; returns {rid: {"status", "tokens",
        "prompt_len", ...}} with every submitted rid present (status
        "ok", "rejected", "shed" or "aborted"; hitting ``max_steps``
        aborts the in-flight requests with their partial tokens).
        ``snapshot_every`` persists the engine to ``snapshot_dir`` every
        N steps; ``drain_at`` stops at that engine step with a final
        snapshot (an orderly drain: a restored engine resumes the
        in-flight work)."""
        if (snapshot_every > 0 or drain_at >= 0) and not snapshot_dir:
            raise ValueError("snapshot_every/drain_at require "
                             "snapshot_dir")
        steps = 0
        while True:
            if drain_at >= 0 and self.stats["steps"] >= drain_at \
                    and self.sched.has_work:
                self.snapshot(snapshot_dir)
                break
            more = self.step()
            steps += 1
            if snapshot_every > 0 and steps % snapshot_every == 0:
                self.snapshot(snapshot_dir)
            if not more:
                break
            if steps >= max_steps:
                self.sched.abort_all(
                    f"engine step cap {max_steps} reached")
                break
        return self.sched.finished

    # ------------------------------------------------------------- #
    def warmup(self) -> None:
        """Run one all-inactive decode step and one all-inactive prefill
        chunk (a recurrent stack's replay is that decode step), outside
        any timed window: builds and loads the kernels and initialises
        the device libraries.  Inactive rows and tokens write nothing,
        so the cache is left as it was."""
        B, C = self.num_slots, self.prefill_chunk
        zi = self._tensor(np.zeros((B,), np.int64))
        zb = self._tensor(np.zeros((B,), bool))
        self._decode(zi, self._tensor(np.zeros((B,), np.int32)), zb, zb)
        if not self.cached_prefill:
            self._sync()
            return
        self._prefill(0, self._tensor(np.zeros((1, C), np.int64)),
                      self._tensor(np.arange(C, dtype=np.int32)[None]),
                      self._tensor(np.zeros((1, C), bool)), True,
                      self._view_bucket(C),
                      self._tensor(np.zeros((1, C, self.cfg.d_model),
                                            np.float32)))
        self._sync()

    # ------------------------------------------------------------- #
    def _snapshot_manager(self, directory: str):
        if directory not in self._snap_mgrs:
            from repro_torch.checkpoint import CheckpointManager
            self._snap_mgrs[directory] = CheckpointManager(directory)
        return self._snap_mgrs[directory]

    def snapshot(self, directory: str) -> int:
        """Persist the whole engine state (KV cache, scheduler, block
        pool, prefix trie, sampling cursors) atomically; see
        :func:`~.resilience.snapshot_engine`.  Returns the snapshot's
        step id."""
        step = snapshot_engine(self, directory)
        self.stats["snapshots"] += 1
        return step

    def restore_snapshot(self, directory: str,
                         step: int | None = None) -> int:
        """Resume from a snapshot taken by an engine of the same
        geometry (call after construction and :meth:`warmup`, which
        leaves the cache as it was).  Returns the restored step id."""
        return restore_engine(self, directory, step)

    def latency_percentiles(self, statuses=("ok",)) -> dict[str, float]:
        """p50/p99 request latency (submit -> terminal entry) over
        ``finished`` entries with the given statuses, in engine steps
        and wall seconds."""
        fin = [e for e in self.sched.finished.values()
               if e["status"] in statuses and "latency_steps" in e]
        if not fin:
            return {"n": 0, "p50_steps": 0.0, "p99_steps": 0.0,
                    "p50_s": 0.0, "p99_s": 0.0}
        steps = np.asarray([e["latency_steps"] for e in fin], np.float64)
        secs = np.asarray([e["latency_s"] for e in fin], np.float64)
        return {"n": len(fin),
                "p50_steps": float(np.percentile(steps, 50)),
                "p99_steps": float(np.percentile(steps, 99)),
                "p50_s": float(np.percentile(secs, 50)),
                "p99_s": float(np.percentile(secs, 99))}

    # ------------------------------------------------------------- #
    def kv_cache_bytes(self) -> int:
        """Device bytes of the KV store (pool or stripes)."""
        return sum(leaf.numel() * leaf.element_size()
                   for sub in self.cache.values() for leaf in sub.values())

    def throughput(self) -> dict[str, float]:
        """``prefill_tok_s`` counts computed tokens only (prefix-cache
        hits skip compute); the effective rate counts every prompt token
        served."""
        s = self.stats
        dt = max(s["prefill_s"], 1e-9)
        return {
            "prefill_tok_s": s["prefill_chunk_tokens"] / dt,
            "prefill_effective_tok_s": s["prefill_tokens"] / dt,
            "decode_tok_s": s["decode_tokens"] / max(s["decode_s"], 1e-9),
        }
