"""Plan execution encoding (the port's own copy of the reference's
``repro.planner.encode``): ShardingPlan -> static-shaped arrays, and the
per-rank visit tables.

:func:`encode_plan` lays one plan out in *plan order*: worker j's tokens
occupy the contiguous slice ``[j*T_loc, (j+1)*T_loc)`` of every (B,
C_pad) array, so splitting the token axis into N equal parts gives each
rank its shard.  Worker j's *non-last* document shards form its compact
Eq.-5 send buffer (``send_idx``, local indices, -1 padded to the pow2
bucket ``buf_len``); ``gath_doc``/``gath_pos`` describe the gathered
buffers of all ranks.  :func:`encode_plan_batch` encodes a batch with a
common ``t_loc`` and ``buf_len``.

A stacked plan-order batch (``doc``/``pos`` (B, C_pad), and for the
flashcp styles the Eq.-5 buffer metadata ``gath_doc``/``gath_pos``
(B, N * buf)) becomes per-rank visit tables: one table set per (sample,
rank), and per hop for ``overlap="chunked"``, with a single batched
:func:`~repro_torch.kernels.doc_attention.build_block_tables` call per
group.  Visit widths and queue lengths are padded to pow2 buckets so few
distinct shapes exist; results are memoized on the metadata content.
The function is numpy and generic over the CP size N.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np

from repro_torch import obs
from repro_torch.kernels.doc_attention import build_block_tables
from repro_torch.table_layout import FLAT_TABLE_NAMES

from .plan import Shard, ShardArrays, ShardingPlan

__all__ = ["PlanEncoding", "encode_plan", "encode_plan_batch",
           "emit_visit_tables", "visit_table_shapes",
           "pick_buffer_bucket", "plan_shape_hints", "trivial_plan"]


def _next_pow2(x: int, floor: int = 128) -> int:
    v = floor
    while v < x:
        v *= 2
    return v


def pick_buffer_bucket(comm_tokens: int, t_loc: int, floor: int = 128) -> int:
    """Static Eq.5 buffer size: pow2 bucket, at most the full local KV."""
    return min(_next_pow2(max(comm_tokens, 1), floor),
               _next_pow2(t_loc, floor))


def _aligned(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align if align > 1 else x


@dataclasses.dataclass
class PlanEncoding:
    """Device-facing encoding of one packed sequence's sharding plan."""

    perm: np.ndarray        # (C_pad,) plan-order -> packed position (-1 pad)
    doc: np.ndarray         # (C_pad,) int32 doc id per plan-order token
    pos: np.ndarray         # (C_pad,) int32 intra-doc position
    send_idx: np.ndarray    # (N, buf_len) int32 local indices, -1 pad
    gath_doc: np.ndarray    # (N * buf_len,) int32, -1 pad
    gath_pos: np.ndarray    # (N * buf_len,) int32
    t_loc: int              # tokens per worker (C_pad // N)
    buf_len: int            # Eq. 5 bucket
    comm_tokens: int        # actual max_j non-last tokens (pre-bucket)
    imbalance: float


def trivial_plan(context_len: int) -> ShardingPlan:
    """Single-worker plan (smoke tests / local mode)."""
    return ShardingPlan(
        doc_lens=np.asarray([context_len], dtype=np.int64),
        shards=[Shard(0, 0, context_len, 0)],
        num_workers=1, comm_style="flashcp")


def _exec_order(plan: ShardingPlan) -> ShardArrays:
    """Shards in execution order: by worker, then (doc_id, start)."""
    a = plan.arrays
    return a._take(np.lexsort((a.start, a.doc_id, a.worker)))


def encode_plan(
    plan: ShardingPlan,
    *,
    buf_len: int | None = None,
    t_loc: int | None = None,
    align: int = 1,
    _out: dict[str, np.ndarray] | None = None,
) -> PlanEncoding:
    """Encode one plan.  ``_out`` optionally supplies preallocated,
    correctly-shaped destination arrays (one row of a batch stack) — the
    batch encoder uses this to write every sample straight into the
    stacked pipeline output with no per-sample allocation or copy."""
    N = plan.num_workers
    doc_starts = np.concatenate([[0], np.cumsum(plan.doc_lens)])[:-1]

    a = _exec_order(plan)
    m = len(a)
    tokens_per_worker = np.bincount(a.worker, weights=a.length,
                                    minlength=N).astype(np.int64)
    need_t = int(tokens_per_worker.max()) if m else 0
    if t_loc is None:
        t_loc = _aligned(need_t, align)
    assert t_loc >= need_t, (t_loc, need_t)

    C_pad = N * t_loc
    if _out is None:
        perm = np.empty(C_pad, np.int64)
        doc = np.empty(C_pad, np.int32)
        pos = np.empty(C_pad, np.int32)
    else:
        perm, doc, pos = _out["perm"], _out["doc"], _out["pos"]

    # ---- one repeat/cumsum expansion builds every per-token array ------ #
    # In exec order, tokens are already laid out contiguously per worker;
    # each worker's run is then *copied* (not scattered) into its
    # [j*t_loc, ...) slice of the padded arrays.  int32 intermediates:
    # context lengths are far below 2**31 and int32 halves the allocator
    # and bandwidth cost of the per-token expansion.
    total = int(a.length.sum())
    len32 = a.length.astype(np.int32)
    excl = np.cumsum(a.length) - a.length          # global exclusive cumsum
    ar = np.arange(total, dtype=np.int32)
    tok_doc = np.repeat(a.doc_id.astype(np.int32), len32)
    tok_pos = ar + np.repeat((a.start - excl).astype(np.int32), len32)
    packed = ar + np.repeat(
        (doc_starts[a.doc_id] + a.start - excl).astype(np.int64), len32)

    # worker runs are copied into their slices; only the (small) per-worker
    # padding tails are filled — never the full C_pad arrays.
    wseg = np.concatenate([[0], np.cumsum(tokens_per_worker)]).astype(np.int64)
    for j in range(N):
        lo, hi = int(wseg[j]), int(wseg[j + 1])
        o = j * t_loc
        run = hi - lo
        if run:
            perm[o: o + run] = packed[lo:hi]
            doc[o: o + run] = tok_doc[lo:hi]
            pos[o: o + run] = tok_pos[lo:hi]
        if run < t_loc:
            perm[o + run: o + t_loc] = -1
            doc[o + run: o + t_loc] = -1
            pos[o + run: o + t_loc] = 0

    # ---- compact per-worker send buffers (non-last shards only) -------- #
    # expanded over non-last shards alone, so the send-side cost scales
    # with the Eq. 5 communication volume, not the context length.
    nl = a.end < plan.doc_lens[a.doc_id]
    nl_len = len32[nl]
    nl_total = int(nl_len.sum())
    nl_excl = np.cumsum(nl_len) - nl_len
    # local (within-worker) start of each shard in plan-order layout
    nl_local = (excl - wseg[a.worker])[nl].astype(np.int32)
    ar_nl = ar[:nl_total]
    send_worker = np.repeat(a.worker[nl].astype(np.int32), nl_len)
    send_count = np.bincount(send_worker, minlength=N).astype(np.int64)
    max_send = int(send_count.max()) if N else 0
    if buf_len is None:
        buf_len = pick_buffer_bucket(max_send, t_loc)
    assert buf_len >= max_send, (
        f"Eq.5 bucket {buf_len} < required send volume {max_send}")

    if _out is None:
        send_idx = np.empty((N, buf_len), np.int32)
        gath_doc = np.empty(N * buf_len, np.int32)
        gath_pos = np.empty(N * buf_len, np.int32)
    else:
        send_idx = _out["send_idx"]
        gath_doc, gath_pos = _out["gath_doc"], _out["gath_pos"]
    if nl_total:
        # rank of each sent token within its worker's buffer: send tokens
        # appear in exec order, so worker groups are contiguous.  Sent
        # prefixes are copied per worker; only padding tails get filled.
        send_local = ar_nl + np.repeat(nl_local - nl_excl, nl_len)
        gd = np.repeat(a.doc_id[nl].astype(np.int32), nl_len)
        gp = ar_nl + np.repeat((a.start[nl].astype(np.int32) - nl_excl),
                               nl_len)
        send_excl = np.cumsum(send_count) - send_count
        sflat = send_idx.reshape(-1)
        for j in range(N):
            lo, cnt = int(send_excl[j]), int(send_count[j])
            o = j * buf_len
            if cnt:
                sflat[o: o + cnt] = send_local[lo: lo + cnt]
                gath_doc[o: o + cnt] = gd[lo: lo + cnt]
                gath_pos[o: o + cnt] = gp[lo: lo + cnt]
            if cnt < buf_len:
                sflat[o + cnt: o + buf_len] = -1
                gath_doc[o + cnt: o + buf_len] = -1
                gath_pos[o + cnt: o + buf_len] = 0
    else:
        send_idx.fill(-1)
        gath_doc.fill(-1)
        gath_pos.fill(0)

    return PlanEncoding(
        perm=perm, doc=doc, pos=pos, send_idx=send_idx,
        gath_doc=gath_doc, gath_pos=gath_pos, t_loc=t_loc, buf_len=buf_len,
        comm_tokens=max_send, imbalance=plan.imbalance_ratio())


def plan_shape_hints(plan: ShardingPlan, *, align: int = 1
                     ) -> tuple[int, int]:
    """(t_loc, buf_len) this plan would pick standalone — computed from the
    plan's accounting arrays without materializing an encoding."""
    t = plan.tokens_per_worker()
    t_loc = _aligned(int(t.max()) if len(t) else 0, align)
    max_send = int(plan.nonlast_tokens_per_worker().max())
    return t_loc, pick_buffer_bucket(max_send, t_loc)


def encode_plan_batch(
    plans: list[ShardingPlan],
    *,
    buf_len: int | None = None,
    t_loc: int | None = None,
    align: int = 1,
) -> tuple[dict[str, np.ndarray], list[PlanEncoding]]:
    """Encode a batch of per-sample plans with a common bucket.

    Returns (stacked arrays dict, per-sample encodings).  All samples share
    ``t_loc`` (max over batch, aligned — or the explicit ``t_loc``, which
    the dispatcher pins to ``C / cp`` so ragged per-group batches keep one
    shape per degree) and ``buf_len`` (the explicit fixed bucket, else the
    bucketed max), derived from the plans' accounting arrays; the samples
    are encoded one after the other, each straight into its row of the
    stacked output.
    """
    with obs.span("encode"):
        N = plans[0].num_workers
        assert all(p.num_workers == N for p in plans)

        hints = [plan_shape_hints(p, align=align) for p in plans]
        need_t = max(h[0] for h in hints)
        if t_loc is None:
            t_loc = need_t
        assert t_loc >= need_t, (t_loc, need_t)
        if buf_len is None:
            buf_len = max(h[1] for h in hints)

        B = len(plans)
        C_pad = N * t_loc
        stack = {
            "perm": np.empty((B, C_pad), np.int64),
            "doc": np.empty((B, C_pad), np.int32),
            "pos": np.empty((B, C_pad), np.int32),
            "send_idx": np.empty((B, N, buf_len), np.int32),
            "gath_doc": np.empty((B, N * buf_len), np.int32),
            "gath_pos": np.empty((B, N * buf_len), np.int32),
        }
        encs = [encode_plan(plans[b], buf_len=buf_len, t_loc=t_loc,
                            _out={k: v[b] for k, v in stack.items()})
                for b in range(B)]
        return stack, encs


def _table_style(strategy: str) -> str:
    if strategy in ("flashcp", "contiguous"):
        return "flashcp"
    if strategy in ("allgather", "llama3", "per_doc", "ring", "ring_zigzag"):
        return "allgather"
    raise ValueError(f"no visit-table style for strategy {strategy!r}")


def _widen_tables(idx: np.ndarray, nvis: np.ndarray, width: int):
    """Pad visit lists to a wider static width (repeat-last no-op slots)."""
    V = idx.shape[-1]
    if width <= V:
        return idx
    last = np.take_along_axis(
        idx, np.maximum(nvis - 1, 0)[..., None], -1)
    pad = np.broadcast_to(last, (*idx.shape[:-1], width - V))
    return np.concatenate([idx, pad], axis=-1)


def _bucketed(idx, nvis, nblocks, pad_to):
    if pad_to == "full":
        return _widen_tables(idx, nvis, nblocks)
    if pad_to == "bucket":
        return _widen_tables(idx, nvis, min(_next_pow2(idx.shape[-1], 8),
                                            nblocks))
    return idx


def _widen_queue(row, col, flags, width):
    """Pad work queues to a wider static step count: repeat-last steps
    with flags 0 (never FIRST/LAST/VALID)."""
    S = row.shape[-1]
    if width <= S:
        return row, col, flags
    pad = width - S
    tail = (*row.shape[:-1], pad)
    return (np.concatenate([row, np.broadcast_to(row[..., -1:], tail)], -1),
            np.concatenate([col, np.broadcast_to(col[..., -1:], tail)], -1),
            np.concatenate([flags, np.zeros(tail, flags.dtype)], -1))


def _queue_bucketed(row, col, flags, worst_steps, pad_to):
    if pad_to == "full":
        return _widen_queue(row, col, flags, worst_steps)
    if pad_to == "bucket":
        width = min(_next_pow2(row.shape[-1], 8), max(worst_steps, 1))
        width = max(width, row.shape[-1])
        return _widen_queue(row, col, flags, width)
    return row, col, flags


def _build_group(q_doc, q_pos, kv_doc, kv_pos, out_shape, *, block_q,
                 block_k, pad_to, grid="rect"):
    """One batched build_block_tables call over flattened (rows, T) pairs,
    reshaped to ``out_shape`` leading dims: the rect 4 (``"rect"`` /
    ``"both"``) and/or the flat 6 (``"flat"`` / ``"both"``) arrays."""
    rows = int(np.prod(out_shape))
    t = build_block_tables(
        q_doc.reshape(rows, -1), q_pos.reshape(rows, -1),
        kv_doc.reshape(rows, -1), kv_pos.reshape(rows, -1),
        block_q=block_q, block_k=block_k)
    nq, nk = t.kv_nvis.shape[-1], t.q_nvis.shape[-1]
    out = {}
    if grid in ("rect", "both"):
        kv_idx = _bucketed(t.kv_idx, t.kv_nvis, nk, pad_to)
        q_idx = _bucketed(t.q_idx, t.q_nvis, nq, pad_to)
        out.update({
            "kv_idx": kv_idx.reshape(*out_shape, nq, -1),
            "kv_nvis": t.kv_nvis.reshape(*out_shape, nq),
            "q_idx": q_idx.reshape(*out_shape, nk, -1),
            "q_nvis": t.q_nvis.reshape(*out_shape, nk),
        })
    if grid in ("flat", "both"):
        worst = nq * nk
        fq = _queue_bucketed(t.fq_row, t.fq_col, t.fq_flags, worst, pad_to)
        rq = _queue_bucketed(t.rq_row, t.rq_col, t.rq_flags, worst, pad_to)
        for name, arr in zip(FLAT_TABLE_NAMES, (*fq, *rq)):
            out[name] = arr.reshape(*out_shape, -1)
    return out


_TABLE_CACHE: OrderedDict[bytes, dict] = OrderedDict()
_TABLE_CACHE_MAX = 8


def emit_visit_tables(
    doc: np.ndarray,
    pos: np.ndarray,
    gath_doc: np.ndarray | None = None,
    gath_pos: np.ndarray | None = None,
    *,
    num_workers: int,
    strategy: str = "flashcp",
    overlap: str = "chunked",
    block_q: int = 128,
    block_k: int = 128,
    pad_to: str = "bucket",
    grid: str = "rect",
    cache: bool = True,
) -> dict[str, np.ndarray]:
    """Per-rank visit tables for a batch-encoded plan.

    Returns ``tab_*`` plan arrays as
    :func:`repro_torch.core.cp_attention.make_cp_context` consumes them:

    * ``overlap="none"``   — ``tab_{kv_idx,kv_nvis,q_idx,q_nvis}``
      (B, N, ...) for the monolithic concat layout (flashcp: ``[local |
      gathered-with-self-masked]``; allgather: full sequence).
    * ``overlap="chunked"`` — ``tab_loc_*`` (B, N, ...) for the local-KV
      partial plus ``tab_hop_*`` (B, N, N-1, ...) where hop h of rank r
      attends the payload of rank (r - 1 - h) mod N.  At N = 1 the hop
      tables are zero-length placeholders.

    ``grid`` selects ``"rect"``, ``"flat"`` or ``"both"`` layouts; widths
    pad to a pow2 bucket (``pad_to="bucket"``) or to the worst case of
    :func:`visit_table_shapes` (``"full"``).
    """
    with obs.span("tables"):
        doc = np.ascontiguousarray(doc, np.int32)
        pos = np.ascontiguousarray(pos, np.int32)
        style = _table_style(strategy)
        if grid not in ("rect", "flat", "both"):
            raise ValueError(f"unknown table grid {grid!r}")
        if style == "flashcp":
            if gath_doc is None or gath_pos is None:
                raise ValueError("flashcp tables need the Eq.5 buffer "
                                 "metadata")
            gath_doc = np.ascontiguousarray(gath_doc, np.int32)
            gath_pos = np.ascontiguousarray(gath_pos, np.int32)

        key = None
        if cache:
            h = hashlib.blake2b(digest_size=16)
            for a in (doc, pos, gath_doc, gath_pos):
                h.update(b"|" if a is None else a.tobytes())
            h.update(f"{num_workers}/{style}/{overlap}/{block_q}/{block_k}/"
                     f"{pad_to}/{grid}".encode())
            key = h.digest()
            hit = _TABLE_CACHE.get(key)
            if hit is not None:
                _TABLE_CACHE.move_to_end(key)
                return dict(hit)

        B, C = doc.shape
        N = num_workers
        t_loc = C // N
        ld = doc.reshape(B, N, t_loc)
        lp = pos.reshape(B, N, t_loc)
        kw = dict(block_q=block_q, block_k=block_k, pad_to=pad_to, grid=grid)

        if overlap == "none":
            if style == "flashcp":
                L = gath_doc.shape[-1]
                buf = L // N
                gd = np.broadcast_to(gath_doc[:, None], (B, N, L)).copy()
                seg = np.arange(L) // buf
                gd[:, seg == np.arange(N)[:, None]] = -2     # self-masked
                gp = np.broadcast_to(gath_pos[:, None], (B, N, L))
                kd = np.concatenate([ld, gd], axis=-1)
                kp = np.concatenate([lp, gp], axis=-1)
            else:
                kd = np.broadcast_to(doc[:, None], (B, N, C))
                kp = np.broadcast_to(pos[:, None], (B, N, C))
            out = {f"tab_{name}": a for name, a in
                   _build_group(ld, lp, kd, kp, (B, N), **kw).items()}
        elif overlap == "chunked":
            out = {f"tab_loc_{name}": a for name, a in
                   _build_group(ld, lp, ld, lp, (B, N), **kw).items()}
            H = N - 1
            if style == "flashcp":
                L = gath_doc.shape[-1]
                segs_d = gath_doc.reshape(B, N, L // N)
                segs_p = gath_pos.reshape(B, N, L // N)
            else:
                segs_d, segs_p = ld, lp
            src = (np.arange(N)[:, None] - 1
                   - np.arange(max(H, 1))[None, :]) % N     # (N, H)
            hop_kd = segs_d[:, src][:, :, :H]               # (B, N, H, seg)
            hop_kp = segs_p[:, src][:, :, :H]
            hop_qd = np.broadcast_to(ld[:, :, None], (B, N, max(H, 1), t_loc)
                                     )[:, :, :H]
            hop_qp = np.broadcast_to(lp[:, :, None], (B, N, max(H, 1), t_loc)
                                     )[:, :, :H]
            if H > 0:
                out.update({f"tab_hop_{name}": a for name, a in
                            _build_group(hop_qd, hop_qp, hop_kd, hop_kp,
                                         (B, N, H), **kw).items()})
            else:
                # zero-hop (N == 1) placeholders, width-matched to
                # visit_table_shapes
                nq = t_loc // block_q
                nk = segs_d.shape[-1] // block_k
                if grid in ("rect", "both"):
                    out.update({
                        "tab_hop_kv_idx": np.zeros((B, N, 0, nq, nk),
                                                   np.int32),
                        "tab_hop_kv_nvis": np.zeros((B, N, 0, nq), np.int32),
                        "tab_hop_q_idx": np.zeros((B, N, 0, nk, nq),
                                                  np.int32),
                        "tab_hop_q_nvis": np.zeros((B, N, 0, nk), np.int32),
                    })
                if grid in ("flat", "both"):
                    out.update({f"tab_hop_{name}":
                                np.zeros((B, N, 0, nq * nk), np.int32)
                                for name in FLAT_TABLE_NAMES})
        else:
            raise ValueError(f"unknown overlap mode {overlap!r}")

        if cache and key is not None:
            _TABLE_CACHE[key] = dict(out)
            while len(_TABLE_CACHE) > _TABLE_CACHE_MAX:
                _TABLE_CACHE.popitem(last=False)
        return out


def _group_shapes(prefix: str, lead: tuple, nq: int, nk: int,
                  grid: str) -> dict[str, tuple]:
    out = {}
    if grid in ("rect", "both"):
        out.update({
            f"{prefix}kv_idx": (*lead, nq, nk),
            f"{prefix}kv_nvis": (*lead, nq),
            f"{prefix}q_idx": (*lead, nk, nq),
            f"{prefix}q_nvis": (*lead, nk),
        })
    if grid in ("flat", "both"):
        # worst-case queue: every row visits every column (then no
        # empty-row sentinels exist), so S_max = nq * nk both ways
        out.update({f"{prefix}{name}": (*lead, nq * nk)
                    for name in FLAT_TABLE_NAMES})
    return out


def visit_table_shapes(B: int, num_workers: int, t_loc: int, buf_len: int,
                       *, strategy: str = "flashcp",
                       overlap: str = "chunked", block_q: int = 128,
                       block_k: int = 128,
                       grid: str = "rect") -> dict[str, tuple]:
    """Worst-case-width static shapes of :func:`emit_visit_tables` output
    (``pad_to="full"`` emission matches them)."""
    N = num_workers
    nq = t_loc // block_q
    style = _table_style(strategy)
    if overlap == "none":
        kv_len = t_loc + N * buf_len if style == "flashcp" else N * t_loc
        nk = kv_len // block_k
        return _group_shapes("tab_", (B, N), nq, nk, grid)
    H = N - 1
    seg = buf_len if style == "flashcp" else t_loc
    nk_loc = t_loc // block_k
    nk_hop = seg // block_k
    return {
        **_group_shapes("tab_loc_", (B, N), nq, nk_loc, grid),
        **_group_shapes("tab_hop_", (B, N, H), nq, nk_hop, grid),
    }
