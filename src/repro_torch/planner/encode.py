"""Visit-table emission for batch-encoded plans (the port's own copy of
the table part of the reference's ``repro.planner.encode``).

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

import hashlib
from collections import OrderedDict

import numpy as np

from repro_torch.kernels.doc_attention import build_block_tables
from repro_torch.table_layout import FLAT_TABLE_NAMES

__all__ = ["emit_visit_tables", "visit_table_shapes", "pick_buffer_bucket"]


def _next_pow2(x: int, floor: int = 128) -> int:
    v = floor
    while v < x:
        v *= 2
    return v


def pick_buffer_bucket(comm_tokens: int, t_loc: int, floor: int = 128) -> int:
    """Static Eq.5 buffer size: pow2 bucket, at most the full local KV."""
    return min(_next_pow2(max(comm_tokens, 1), floor),
               _next_pow2(t_loc, floor))


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
    doc = np.ascontiguousarray(doc, np.int32)
    pos = np.ascontiguousarray(pos, np.int32)
    style = _table_style(strategy)
    if grid not in ("rect", "flat", "both"):
        raise ValueError(f"unknown table grid {grid!r}")
    if style == "flashcp":
        if gath_doc is None or gath_pos is None:
            raise ValueError("flashcp tables need the Eq.5 buffer metadata")
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
                    "tab_hop_kv_idx": np.zeros((B, N, 0, nq, nk), np.int32),
                    "tab_hop_kv_nvis": np.zeros((B, N, 0, nq), np.int32),
                    "tab_hop_q_idx": np.zeros((B, N, 0, nk, nq), np.int32),
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
