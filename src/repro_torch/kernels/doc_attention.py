"""Document-masked causal flash attention with block-level sparsity: the
visit tables (host, numpy), the three training kernels' wrappers, and
their plain PyTorch twins.

The host half is the port's own copy of the reference's table builders
(``repro.kernels.doc_attention``): per query block the host lists exactly
the KV blocks holding any visible key, and the kernels fetch only those.
Two schedules walk the same visit sets:

* ``grid="rect"`` — per output block row, a padded list ``idx (B, R, V)``
  and its length ``nvis (B, R)``;
* ``grid="flat"`` — a flattened work queue ``(row, col, flags)``, each
  (B, S): every row's steps are one contiguous run that starts at a
  FIRST step and ends at a LAST step, rows in descending visit count
  (LPT), empty rows one sentinel step (FIRST|LAST, not VALID), and a
  pad tail of flags 0 (:func:`build_work_queue`).

Layout (GQA): q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D); per-token
``q_doc/q_pos`` (B, Tq) and ``kv_doc/kv_pos`` (B, Tk) int32; doc id < 0
is padding.  A (query, key) pair is visible iff same doc, q_pos >=
kv_pos, and both docs >= 0.

Kernels (``csrc/doc_attention.cu``, built by ``_build`` at first use),
each with the reference's signature minus ``interpret``:

* :func:`flash_fwd` -> ``(o, lse)``: o in q's dtype, lse f32 (-inf on
  rows that see nothing; their o is 0).  In bf16 it runs on the tensor
  cores and takes head dims that are a multiple of 16 (others raise):
  on wgmma from TMA-fed shared memory where block_q, block_k and D are
  each 64 or 128, on mma.sync elsewhere (:func:`fwd_kernel_for`, by
  shape alone; ``.wgmma_launches`` counts the first);
* :func:`flash_bwd_dq` -> dq, over the same q-block rows and tables.
  In bf16 it runs on the tensor cores, takes head dims that are a
  multiple of 16 (others raise), and rounds only where the reference
  does (dS to k's dtype before dS·K);
* :func:`flash_bwd_dkv` -> ``(dk, dv)``, over the reverse tables
  (kv-block rows visited by q blocks), the GQA group summed in f32.  In
  bf16 it runs on the tensor cores, takes head dims that are a multiple
  of 16 (others raise), and, like the reference, rounds neither Pᵀ nor
  dSᵀ: each enters its dV or dK product as a hi + lo pair of bf16
  operands (two tensor-core products into one f32 sum); a KV block row
  is split into key parts and the GQA group into slices
  (:func:`dkv_split_plan`), the slices summed in f32 in a fixed order
  (:func:`flash_bwd_dkv_split_plain` is that split's plain form).

A wrapper given CPU tensors runs its twin (``flash_fwd_plain``,
``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``): plain PyTorch that
walks the same tables block by block with the reference kernel's
arithmetic — the ``NEG`` masking, ``lse_safe``, the empty-row rules, and
its rounding (forward: p to v's dtype before PV; dQ: dS to k's dtype
before dS·K; dKV: nothing rounded).  Given CUDA tensors it launches its
kernel or raises.  Each kernel wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import sm_count
from repro_torch.table_layout import GRID_TABLE_HALF

__all__ = [
    "BlockTables", "build_block_tables", "build_work_queue",
    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_fwd_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
    "flash_bwd_dkv_split_plain", "dkv_split_plan", "fwd_kernel_for",
    "run_starts",
    "DEFAULT_BLOCK_Q", "DEFAULT_BLOCK_K",
    "FLAG_FIRST", "FLAG_LAST", "FLAG_VALID", "NEG",
]

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG = -1e30  # finite -inf stand-in inside kernels (no nan from inf-inf)

# block-pair kinds of the legacy builder
KIND_SKIP, KIND_PARTIAL, KIND_FULL = 0, 1, 2

# work-queue step flags (build_work_queue / the grid="flat" kernels)
FLAG_FIRST = 1   # first step of its block-row: reset the accumulators
FLAG_LAST = 2    # last step of its block-row: finalize + write outputs
FLAG_VALID = 4   # a real visit (unset on empty-row sentinels / pad tail)


# ===================================================================== #
# host-side visit tables (numpy; the reference's builders)
# ===================================================================== #
@dataclasses.dataclass
class BlockTables:
    """Visit tables driving the sparse kernels.

    Rectangular layout (``grid="rect"``): fwd/dQ ``kv_idx``/``kv_nvis``
    per (b, q-block); dKV the reverse map ``q_idx``/``q_nvis`` per
    (b, kv-block).  Padded slots repeat the last valid index and are
    gated by the counts.  Flattened layout (``grid="flat"``): the same
    visit sets as work queues, ``fq_*`` over q-block rows and ``rq_*``
    over kv-block rows, derived lazily on first access.
    """

    kv_idx: np.ndarray    # (B, nq, Vk) int32
    kv_nvis: np.ndarray   # (B, nq)     int32
    q_idx: np.ndarray     # (B, nk, Vq) int32
    q_nvis: np.ndarray    # (B, nk)     int32
    block_q: int
    block_k: int
    visited_frac: float   # visited blocks / all blocks
    full_frac: float      # fully-visible blocks / visited blocks
    _queues: tuple = dataclasses.field(default=None, repr=False)

    def _flat(self):
        if self._queues is None:
            self._queues = (*build_work_queue(self.kv_idx, self.kv_nvis),
                            *build_work_queue(self.q_idx, self.q_nvis))
        return self._queues

    @property
    def fq_row(self):
        return self._flat()[0]

    @property
    def fq_col(self):
        return self._flat()[1]

    @property
    def fq_flags(self):
        return self._flat()[2]

    @property
    def rq_row(self):
        return self._flat()[3]

    @property
    def rq_col(self):
        return self._flat()[4]

    @property
    def rq_flags(self):
        return self._flat()[5]

    def as_torch(self, device):
        """The rect 4-tuple ``(kv_idx, kv_nvis, q_idx, q_nvis)``."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (self.kv_idx, self.kv_nvis, self.q_idx,
                               self.q_nvis))

    def flat_as_torch(self, device):
        """The flat 6-tuple the ``grid="flat"`` kernels consume."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in self._flat())


def build_work_queue(idx: np.ndarray, nvis: np.ndarray, *,
                     pad_to_steps: int | None = None):
    """Flatten rectangular visit tables into the 1D work-queue schedule.

    Returns ``(row, col, flags)``, each (B, S) int32: per sample the
    row-major visit list re-ordered so rows run in descending visit count
    (LPT), each row's visits contiguous and ascending.  Empty rows get
    one sentinel step (FIRST|LAST, not VALID); samples pad to a common S
    (and to ``pad_to_steps``) by repeating the final step with flags 0.
    """
    idx = np.asarray(idx, np.int32)
    nvis = np.asarray(nvis)
    B, R, V = idx.shape
    nv = nvis.astype(np.int64)
    counts = np.maximum(nv, 1)              # sentinel step for empty rows
    s_real = counts.sum(axis=1)
    S = int(s_real.max()) if B else 1
    if pad_to_steps is not None:
        if pad_to_steps < S:
            raise ValueError(f"pad_to_steps {pad_to_steps} < {S} steps")
        S = pad_to_steps
    row = np.zeros((B, S), np.int32)
    col = np.zeros((B, S), np.int32)
    flags = np.zeros((B, S), np.int32)
    for b in range(B):
        order = np.argsort(-nv[b], kind="stable")
        oc = counts[b][order]
        total = int(s_real[b])
        excl = np.cumsum(oc) - oc
        owner = np.repeat(order, oc).astype(np.int64)
        offs = np.arange(total, dtype=np.int64) - np.repeat(excl, oc)
        valid = offs < nv[b][owner]
        row[b, :total] = owner
        col[b, :total] = idx[b][owner, np.minimum(offs, V - 1)]
        flags[b, :total] = (
            FLAG_FIRST * (offs == 0)
            + FLAG_LAST * (offs == counts[b][owner] - 1)
            + FLAG_VALID * valid)
        if total < S:                        # repeat-last no-op pad tail
            row[b, total:] = row[b, total - 1]
            col[b, total:] = col[b, total - 1]
    return row, col, flags


_BIG = np.int32(1 << 30)     # invalid-token sentinel in int32 summaries
_KEY = np.int64(1) << 31     # (doc, pos) composite-key stride


def _scatter_lists(rows: np.ndarray, vals: np.ndarray, nvis: np.ndarray,
                   width: int) -> np.ndarray:
    """(R, width) visit table from sorted pair lists; padded slots repeat
    the last valid index, empty rows are zeros."""
    R = nvis.shape[0]
    starts = np.zeros(R + 1, np.int64)
    np.cumsum(nvis, out=starts[1:])
    slot = np.arange(vals.shape[0], dtype=np.int64) - starts[rows]
    idx = np.zeros((R, width), np.int32)
    idx[rows, slot] = vals
    pad = np.arange(width, dtype=np.int32)[None, :] >= nvis[:, None]
    last = idx[np.arange(R), np.maximum(nvis - 1, 0)]
    np.copyto(idx, np.broadcast_to(last[:, None], idx.shape), where=pad)
    return idx


def _summ32(doc: np.ndarray, pos: np.ndarray, blk: int):
    """Per-block int32 summaries: (dmin, dmax, pmin, pmax, all_valid,
    single_doc).  Empty blocks encode as dmin=BIG / dmax=-1."""
    d = doc.reshape(doc.shape[0], -1, blk)
    p = pos.reshape(pos.shape[0], -1, blk)
    valid = d >= 0
    dmin = np.where(valid, d, _BIG).min(-1).astype(np.int32)
    dmax = np.where(valid, d, -1).max(-1).astype(np.int32)
    pmin = np.where(valid, p, _BIG).min(-1).astype(np.int32)
    pmax = np.where(valid, p, -1).max(-1).astype(np.int32)
    return dmin, dmax, pmin, pmax, valid.all(-1), dmin == dmax


def _detect_segments(kdmin, kdmax, kpmin, kpmax, ksingle) -> np.ndarray:
    """Cut points splitting one row's KV blocks into (doc, pos)-monotone
    runs, the property the interval path needs."""
    nonempty = kdmax >= 0
    edmin = np.where(nonempty, kdmin, _BIG)
    edmax = np.where(nonempty, kdmax, _BIG)
    brk = edmin[1:] < edmax[:-1]
    same = ksingle[1:] & ksingle[:-1] & (kdmin[1:] == kdmin[:-1])
    brk |= same & ((kpmin[1:] < kpmin[:-1]) | (kpmax[1:] < kpmax[:-1]))
    return np.flatnonzero(brk) + 1


def _pairs_dense(qs, ks):
    """O(nq*nk) classification of one row -> (visited pairs, full count)."""
    qdmin, qdmax, qpmin, qpmax, q_all, qsing = qs
    kdmin, kdmax, kpmin, kpmax, k_all, ksing = ks
    vis = qdmax[:, None] >= kdmin[None, :]
    vis &= kdmax[None, :] >= qdmin[:, None]
    qd_s = np.where(qsing, qdmin, np.int32(-3))
    kd_s = np.where(ksing, kdmin, np.int32(-4))
    sd = qd_s[:, None] == kd_s[None, :]
    anti = sd & (qpmax[:, None] < kpmin[None, :])
    np.logical_not(anti, out=anti)
    vis &= anti
    qpf = np.where(q_all, qpmin, np.int32(-1))
    kpf = np.where(k_all, kpmax, _BIG)
    full = qpf[:, None] >= kpf[None, :]
    full &= sd
    full &= vis
    qrows, cols = np.nonzero(vis)
    nvis = np.count_nonzero(vis, axis=-1).astype(np.int32)
    return qrows, cols.astype(np.int32), nvis, int(full.sum())


def _pairs_intervals(qs, ks, cuts, nk):
    """Sorted-segment classification of one row in O((nq + pairs) log nk):
    per (q block, monotone segment) at most two index intervals, found by
    binary search on the block summaries.  Exactly the dense result."""
    qdmin, qdmax, qpmin, qpmax, q_all, qsing = qs
    kdmin, kdmax, kpmin, kpmax, k_all, ksing = ks
    nq = qdmin.shape[0]
    nonempty = kdmax >= 0
    edmin = np.where(nonempty, kdmin, _BIG)
    edmax = np.where(nonempty, kdmax, _BIG)
    qd64 = qdmin.astype(np.int64) * _KEY
    bounds = [0, *cuts.tolist(), nk]
    S = len(bounds) - 1
    starts = np.zeros((nq, S, 2), np.int64)
    lens = np.zeros((nq, S, 2), np.int64)
    n_full = 0
    for si in range(S):
        s, e = bounds[si], bounds[si + 1]
        lo = s + np.searchsorted(edmax[s:e], qdmin)
        hi = s + np.searchsorted(edmin[s:e], qdmax, side="right")
        hi = np.maximum(hi, lo)
        # anti-causal suffix of the q-doc's single-block run
        sidx = s + np.flatnonzero(ksing[s:e])
        anti_lo = anti_hi = hi
        if sidx.size:
            skey = kdmin[sidx].astype(np.int64) * _KEY + kpmin[sidx]
            r1 = np.searchsorted(skey, qd64 + (_KEY - 1), side="right")
            cnt = r1 - np.searchsorted(skey, qd64 + qpmax, side="right")
            cnt = np.where(qsing & (r1 > 0), cnt, 0)
            last = sidx[np.maximum(r1 - 1, 0)]
            anti_hi = np.where(cnt > 0, last + 1, hi)
            anti_lo = anti_hi - np.where(cnt > 0, cnt, 0)
            fidx = sidx[k_all[sidx]]
            if fidx.size:
                fkey = kdmin[fidx].astype(np.int64) * _KEY + kpmax[fidx]
                nf = (np.searchsorted(fkey, qd64 + qpmin, side="right")
                      - np.searchsorted(fkey, qd64))
                n_full += int(nf[qsing & q_all].sum())
        starts[:, si, 0] = lo
        lens[:, si, 0] = np.maximum(anti_lo - lo, 0)
        starts[:, si, 1] = anti_hi
        lens[:, si, 1] = np.maximum(hi - anti_hi, 0)
    flat_lens = lens.reshape(-1)
    flat_starts = starts.reshape(-1)
    total = int(flat_lens.sum())
    ar = np.arange(total, dtype=np.int64)
    excl = np.cumsum(flat_lens) - flat_lens
    cols = (ar + np.repeat(flat_starts - excl, flat_lens)).astype(np.int32)
    nvis = lens.sum((1, 2)).astype(np.int32)
    qrows = np.repeat(np.arange(nq, dtype=np.int64), nvis)
    return qrows, cols, nvis, n_full


def build_block_tables(q_doc, q_pos, kv_doc, kv_pos, *,
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K,
                       legacy: bool = False) -> BlockTables:
    """Classify every (q-block, kv-block) pair as skipped or visited.

    A pair is skipped only when provably no element is visible.  Plan-
    ordered, (doc, pos)-monotone KV segments resolve each q block's
    visits by binary search on the block summaries; layouts with many
    segments take the dense classification.  ``legacy=True`` selects the
    reference's original O(nq x nk) list-of-lists construction
    (:func:`_build_block_tables_legacy`), kept only as the parity and
    benchmark baseline: it returns the same tables.
    """
    q_doc = np.asarray(q_doc)
    q_pos = np.asarray(q_pos)
    kv_doc = np.asarray(kv_doc)
    kv_pos = np.asarray(kv_pos)
    B, Tq = q_doc.shape
    _, Tk = kv_doc.shape
    if Tq % block_q or Tk % block_k:
        raise ValueError(f"lengths {Tq}, {Tk} are not multiples of blocks "
                         f"{block_q}, {block_k}")
    nq, nk = Tq // block_q, Tk // block_k

    if legacy:
        return _build_block_tables_legacy(q_doc, q_pos, kv_doc, kv_pos,
                                          block_q=block_q, block_k=block_k)

    qsum = _summ32(q_doc, q_pos, block_q)
    ksum = _summ32(kv_doc, kv_pos, block_k)

    per_row = []
    n_visited = n_full = 0
    for b in range(B):
        qs = tuple(a[b] for a in qsum)
        ks = tuple(a[b] for a in ksum)
        cuts = _detect_segments(ks[0], ks[1], ks[2], ks[3], ks[5])
        if cuts.size + 1 > max(8, nk // 8):
            qrows, cols, nvis, nf = _pairs_dense(qs, ks)
        else:
            qrows, cols, nvis, nf = _pairs_intervals(qs, ks, cuts, nk)
        per_row.append((qrows, cols, nvis))
        n_visited += int(nvis.sum())
        n_full += nf

    Vk = max(1, max(int(r[2].max()) if r[2].size else 0 for r in per_row))
    rev_nvis = [np.bincount(cols, minlength=nk).astype(np.int32)
                for _, cols, _ in per_row]
    Vq = max(1, max(int(n.max()) if n.size else 0 for n in rev_nvis))

    kv_idx = np.zeros((B, nq, Vk), np.int32)
    kv_nvis = np.zeros((B, nq), np.int32)
    q_idx = np.zeros((B, nk, Vq), np.int32)
    q_nvis = np.zeros((B, nk), np.int32)
    for b, (qrows, cols, nvis) in enumerate(per_row):
        kv_idx[b] = _scatter_lists(qrows, cols, nvis, Vk)
        kv_nvis[b] = nvis
        order = np.lexsort((qrows, cols))      # by kv block, q ascending
        q_idx[b] = _scatter_lists(cols[order], qrows[order].astype(np.int32),
                                  rev_nvis[b], Vq)
        q_nvis[b] = rev_nvis[b]

    return BlockTables(
        kv_idx=kv_idx, kv_nvis=kv_nvis, q_idx=q_idx, q_nvis=q_nvis,
        block_q=block_q, block_k=block_k,
        visited_frac=n_visited / max(B * nq * nk, 1),
        full_frac=n_full / max(n_visited, 1),
    )


def _pad_lists(lists: list[list[int]], width: int) -> np.ndarray:
    out = np.zeros((len(lists), width), dtype=np.int32)
    for i, l in enumerate(lists):
        if l:
            out[i, : len(l)] = l
            out[i, len(l):] = l[-1]  # repeat-last padding => no-op refetch
    return out


def _build_block_tables_legacy(q_doc, q_pos, kv_doc, kv_pos, *, block_q,
                               block_k) -> BlockTables:
    """The seed implementation, frozen as the parity/benchmark baseline:
    every (b, q-block, kv-block) pair classified skip / partial / full on
    broadcast block summaries, then the visit lists built in Python."""
    B, Tq = q_doc.shape
    _, Tk = kv_doc.shape
    nq, nk = Tq // block_q, Tk // block_k

    def summarize(doc, pos, blk):
        d = doc.reshape(B, -1, blk)
        p = pos.reshape(B, -1, blk)
        valid = d >= 0
        big = np.int64(1 << 40)
        dmin = np.where(valid, d, big).min(-1)
        dmax = np.where(valid, d, -1).max(-1)
        pmin = np.where(valid, p, big).min(-1)
        pmax = np.where(valid, p, -1).max(-1)
        any_valid = valid.any(-1)
        all_valid = valid.all(-1)
        return dmin, dmax, pmin, pmax, any_valid, all_valid

    qdmin, qdmax, qpmin, qpmax, q_any, q_all = summarize(q_doc, q_pos, block_q)
    kdmin, kdmax, kpmin, kpmax, k_any, k_all = summarize(kv_doc, kv_pos,
                                                         block_k)

    # broadcast to (B, nq, nk)
    def bq_(x):
        return x[:, :, None]

    def bk_(x):
        return x[:, None, :]

    overlap = (bq_(qdmax) >= bk_(kdmin)) & (bk_(kdmax) >= bq_(qdmin))
    single_doc = (bq_(qdmin) == bq_(qdmax)) & (bk_(kdmin) == bk_(kdmax)) \
        & (bq_(qdmin) == bk_(kdmin))
    # single shared doc and strictly anti-causal -> nothing visible
    anti = single_doc & (bq_(qpmax) < bk_(kpmin))
    visited = overlap & ~anti & bq_(q_any) & bk_(k_any)
    full = single_doc & (bq_(qpmin) >= bk_(kpmax)) & bq_(q_all) & bk_(k_all)
    full &= visited

    kinds = np.where(visited, np.where(full, KIND_FULL, KIND_PARTIAL),
                     KIND_SKIP).astype(np.int32)

    kv_lists = [[int(k) for k in np.nonzero(kinds[b, qi])[0]]
                for b in range(B) for qi in range(nq)]
    q_lists = [[int(q) for q in np.nonzero(kinds[b, :, ki])[0]]
               for b in range(B) for ki in range(nk)]
    Vk = max(1, max((len(l) for l in kv_lists), default=0))
    Vq = max(1, max((len(l) for l in q_lists), default=0))

    kv_idx = _pad_lists(kv_lists, Vk).reshape(B, nq, Vk)
    kv_nvis = np.array([len(l) for l in kv_lists], np.int32).reshape(B, nq)
    q_idx = _pad_lists(q_lists, Vq).reshape(B, nk, Vq)
    q_nvis = np.array([len(l) for l in q_lists], np.int32).reshape(B, nk)

    n_visited = int((kinds != KIND_SKIP).sum())
    n_full = int((kinds == KIND_FULL).sum())
    return BlockTables(
        kv_idx=kv_idx, kv_nvis=kv_nvis, q_idx=q_idx, q_nvis=q_nvis,
        block_q=block_q, block_k=block_k,
        visited_frac=n_visited / max(kinds.size, 1),
        full_frac=n_full / max(n_visited, 1),
    )


def _check_grid(grid: str, tables) -> tuple:
    tables = tuple(tables)
    want = GRID_TABLE_HALF.get(grid)
    if want is None:
        raise ValueError(f"unknown kernel grid {grid!r}")
    if len(tables) != want:
        raise ValueError(f"grid={grid!r} kernels take {want} table arrays, "
                         f"got {len(tables)}")
    return tables


# ===================================================================== #
# plain twins: the same tables, walked block by block
# ===================================================================== #
def _row_visits(tables, grid: str, n_rows: int):
    """Per output block row, its visited blocks in walk order:
    ``(idx (B, n_rows, W) int64, nvis (B, n_rows) int64)``.

    rect tables are that already.  A flat queue is regrouped: each VALID
    step belongs to the row of its run and sits at its offset from the
    run's FIRST step; sentinel and pad-tail steps are not VALID and drop
    out, so empty rows get nvis 0."""
    if grid == "rect":
        idx, nvis = tables
        return idx.long(), nvis.long()
    row, col, flags = tables
    B, S = row.shape
    dev = row.device
    valid = (flags & FLAG_VALID) != 0
    first = (flags & FLAG_FIRST) != 0
    step = torch.arange(S, device=dev).expand(B, S)
    start = torch.where(first, step, torch.zeros_like(step)).cummax(1).values
    bi, si = valid.nonzero(as_tuple=True)
    r = row[bi, si].long()
    off = (step - start)[bi, si]
    nvis = torch.zeros((B, n_rows), dtype=torch.long, device=dev)
    nvis.index_put_((bi, r), torch.ones_like(r), accumulate=True)
    width = max(int(nvis.max()) if nvis.numel() else 0, 1)
    idx = torch.zeros((B, n_rows, width), dtype=torch.long, device=dev)
    idx[bi, r, off] = col[bi, si].long()
    return idx, nvis


def _blocks(x, n: int, blk: int):
    """(B, H, T, D) -> (B, H, n, blk, D)."""
    B, H, _, D = x.shape
    return x.reshape(B, H, n, blk, D)


def _gather_blocks(xb, c):
    """xb (B, H, n, blk, D) at block ids c (B, R) -> (B, H, R, blk, D)."""
    bi = torch.arange(xb.shape[0], device=xb.device)[:, None]
    return xb[bi, :, c].permute(0, 2, 1, 3, 4)


def _visible(qd, qp, kd, kp):
    """Per-token metadata (B, R, bq) and (B, R, bk) -> (B, R, bq, bk)."""
    qd, qp = qd[..., :, None], qp[..., :, None]
    kd, kp = kd[..., None, :], kp[..., None, :]
    return (qd == kd) & (qp >= kp) & (qd >= 0) & (kd >= 0)


def _gqa(x, Hkv: int):
    """(B, Hq, ...) -> (B, Hkv, G, ...)."""
    return x.reshape(x.shape[0], Hkv, x.shape[1] // Hkv, *x.shape[2:])


def flash_fwd_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos, tables, *,
                    scale: float, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """Twin of :func:`flash_fwd`: per q-block row, an online softmax over
    its visited KV blocks in table order, one whole block per update as
    the reference kernel does; p is rounded to v's dtype before PV and l
    sums the unrounded p."""
    tables = _check_grid(grid, tables)
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    nq, nk = Tq // block_q, Tk // block_k
    idx, nvis = _row_visits(tables, grid, nq)
    qf = _gqa(_blocks(q, nq, block_q), Hkv).float()   # (B,Hkv,G,nq,bq,D)
    kb, vb = _blocks(k, nk, block_k), _blocks(v, nk, block_k)
    qd = q_doc.reshape(B, nq, block_q)
    qp = q_pos.reshape(B, nq, block_q)
    kdb = kv_doc.reshape(B, nk, block_k)
    kpb = kv_pos.reshape(B, nk, block_k)
    bi = torch.arange(B, device=q.device)[:, None]
    acc = torch.zeros_like(qf)
    m = torch.full((*qf.shape[:-1], 1), NEG, device=q.device)
    l = torch.zeros_like(m)
    for w in range(idx.shape[-1]):
        c = idx[..., w]
        kc = _gather_blocks(kb, c).float()                 # (B,Hkv,nq,bk,D)
        vc = _gather_blocks(vb, c)
        vis = _visible(qd, qp, kdb[bi, c], kpb[bi, c])
        vis = (vis & (w < nvis)[..., None, None])[:, None, None]
        s = torch.einsum("bhgnid,bhnjd->bhgnij", qf, kc) * scale
        s = torch.where(vis, s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhgnij,bhnjd->bhgnid", p.to(v.dtype).float(),
                          vc.float())
        acc = acc * alpha + pv
        m = m_new
    out = torch.where(l > 0, acc / torch.clamp(l, min=1e-30), 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      float("-inf"))
    return (out.reshape(B, Hq, Tq, D).to(q.dtype),
            lse.reshape(B, Hq, Tq))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc,
                       kv_pos, tables, *, scale: float,
                       block_q: int = DEFAULT_BLOCK_Q,
                       block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """Twin of :func:`flash_bwd_dq`: P recomputed from lse (0 on rows
    with lse -inf), dS = P (dO·Vᵀ - delta) scale rounded to k's dtype,
    dQ = Σ dS·K in f32."""
    tables = _check_grid(grid, tables)
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    nq, nk = Tq // block_q, Tk // block_k
    idx, nvis = _row_visits(tables, grid, nq)
    qf = _gqa(_blocks(q, nq, block_q), Hkv).float()
    dof = _gqa(_blocks(do, nq, block_q), Hkv).float()
    lse = _gqa(lse.reshape(B, Hq, nq, block_q, 1), Hkv)
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    dl = _gqa(delta.reshape(B, Hq, nq, block_q, 1), Hkv)
    kb, vb = _blocks(k, nk, block_k), _blocks(v, nk, block_k)
    qd = q_doc.reshape(B, nq, block_q)
    qp = q_pos.reshape(B, nq, block_q)
    kdb = kv_doc.reshape(B, nk, block_k)
    kpb = kv_pos.reshape(B, nk, block_k)
    bi = torch.arange(B, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    for w in range(idx.shape[-1]):
        c = idx[..., w]
        kc = _gather_blocks(kb, c)
        vc = _gather_blocks(vb, c).float()
        vis = _visible(qd, qp, kdb[bi, c], kpb[bi, c])
        vis = (vis & (w < nvis)[..., None, None])[:, None, None]
        s = torch.einsum("bhgnid,bhnjd->bhgnij", qf, kc.float()) * scale
        p = torch.where(vis, torch.exp(s - lse_safe), 0.0)
        dp = torch.einsum("bhgnid,bhnjd->bhgnij", dof, vc)
        ds = p * (dp - dl) * scale
        dq = dq + torch.einsum("bhgnij,bhnjd->bhgnid",
                               ds.to(k.dtype).float(), kc.float())
    return dq.reshape(B, Hq, Tq, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc,
                        kv_pos, tables, *, scale: float,
                        block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """Twin of :func:`flash_bwd_dkv`: per kv-block row, over the reverse
    tables, dV += Pᵀ·dO and dK += dSᵀ·Q summed over the GQA group, all
    in f32 (nothing rounded before the products, as the reference
    defines it; the bf16 kernel carries Pᵀ and dSᵀ as hi + lo bf16
    pairs to the same effect)."""
    tables = _check_grid(grid, tables)
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    nq, nk = Tq // block_q, Tk // block_k
    idx, nvis = _row_visits(tables, grid, nk)
    qb = _blocks(q, nq, block_q).float()                  # (B,Hq,nq,bq,D)
    dob = _blocks(do, nq, block_q).float()
    lse = lse.reshape(B, Hq, nq, block_q, 1)
    lse_b = torch.where(torch.isfinite(lse), lse, 0.0)
    dl_b = delta.reshape(B, Hq, nq, block_q, 1)
    kf = _blocks(k, nk, block_k).float()                  # (B,Hkv,nk,bk,D)
    vf = _blocks(v, nk, block_k).float()
    qdb = q_doc.reshape(B, nq, block_q)
    qpb = q_pos.reshape(B, nq, block_q)
    kd = kv_doc.reshape(B, nk, block_k)
    kp = kv_pos.reshape(B, nk, block_k)
    bi = torch.arange(B, device=q.device)[:, None]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for w in range(idx.shape[-1]):
        c = idx[..., w]                                   # (B, nk) q blocks
        qc = _gqa(_gather_blocks(qb, c), Hkv)             # (B,Hkv,G,nk,bq,D)
        doc = _gqa(_gather_blocks(dob, c), Hkv)
        lse_c = _gqa(_gather_blocks(lse_b, c), Hkv)
        dl_c = _gqa(_gather_blocks(dl_b, c), Hkv)
        vis = _visible(qdb[bi, c], qpb[bi, c], kd, kp)
        vis = (vis & (w < nvis)[..., None, None])[:, None, None]
        s = torch.einsum("bhgnid,bhnjd->bhgnij", qc, kf) * scale
        p = torch.where(vis, torch.exp(s - lse_c), 0.0)
        dv = dv + torch.einsum("bhgnij,bhgnid->bhnjd", p, doc)
        dp = torch.einsum("bhgnid,bhnjd->bhgnij", doc, vf)
        ds = p * (dp - dl_c) * scale
        dk = dk + torch.einsum("bhgnij,bhgnid->bhnjd", ds, qc)
    return (dk.reshape(B, Hkv, Tk, D).to(k.dtype),
            dv.reshape(B, Hkv, Tk, D).to(v.dtype))


def flash_bwd_dkv_split_plain(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc,
                              kv_pos, tables, *, scale: float,
                              group_slices: int,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K,
                              grid: str = "rect"):
    """Plain form of the bf16 dK/dV kernel's group split: slice s holds
    heads [s * gps, (s + 1) * gps) of every GQA group (gps = ceil(G /
    group_slices); a slice past G is empty), each slice's f32 dK, dV is
    the twin's sum over its heads, and the slices are summed in order
    before the cast.  Key parts change nothing here: each key's sums are
    its own."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    gps = -(-G // group_slices)
    dk = dv = None
    for s in range(group_slices):
        heads = [h * G + g for h in range(Hkv)
                 for g in range(s * gps, min(G, (s + 1) * gps))]
        if not heads:
            continue
        hi = torch.tensor(heads, device=q.device)
        sk, sv = flash_bwd_dkv_plain(
            q[:, hi], k.float(), v.float(), do[:, hi], lse[:, hi],
            delta[:, hi], q_doc, q_pos, kv_doc, kv_pos, tables, scale=scale,
            block_q=block_q, block_k=block_k, grid=grid)
        dk = sk if dk is None else dk + sk
        dv = sv if dv is None else dv + sv
    return dk.to(k.dtype), dv.to(v.dtype)


# ===================================================================== #
# kernel wrappers
# ===================================================================== #
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"fwd": 0, "dq": 1, "dkv": 2, "fwd_wgmma": 3}
#: shared memory one block may use on Hopper
_SMEM_LIMIT = 232_448
#: keys per sub-tile of the CUDA kernels: block_k must be a multiple
KEY_TILE = 32
#: keys per sub-tile of the bf16 dQ kernel where block_k allows it, else
#: KEY_TILE (32 or 64; chosen by scripts/paged_split_sweep.py)
DQ_KEY_TILE = 64
#: the bf16 dK/dV kernel's split of a KV block row into key parts (16
#: keys per warp), and the CTAs per SM that its group slices aim for
#: (chosen by scripts/paged_split_sweep.py)
DKV_KEY_PARTS = 1
DKV_CTAS_PER_SM = 4


def dkv_split_plan(B: int, Hkv: int, rows: int, G: int, block_k: int,
                   sms: int = 132) -> tuple[int, int]:
    """``(key_parts, group_slices)`` of the bf16 dK/dV kernel, from
    shapes only (never from the tables: no host sync).  A block row's
    keys split into DKV_KEY_PARTS parts where block_k allows it; the GQA
    group splits into the fewest slices (a divisor of G) that give
    B * Hkv * rows * parts * slices >= DKV_CTAS_PER_SM * sms CTAs, so
    that one row with many visits does not set the kernel's time
    alone."""
    parts = DKV_KEY_PARTS if block_k % (16 * DKV_KEY_PARTS) == 0 else 1
    ctas = B * Hkv * rows * parts
    slices = next((d for d in range(1, G + 1)
                   if G % d == 0 and ctas * d >= DKV_CTAS_PER_SM * sms), G)
    return parts, slices


def _on_cpu(*tensors) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def run_starts(flags, n_rows: int):
    """(B, n_rows) int32: the queue position of each run's FIRST step, in
    queue order — queue row i of sample b starts at ``starts[b, i]``.
    Every row, empty or not, has exactly one FIRST step.  Computed on the
    device without a host sync; a slot no FIRST step reaches stays -1."""
    B, S = flags.shape
    first = (flags & FLAG_FIRST) != 0
    ordinal = torch.cumsum(first.to(torch.int32), dim=1) - 1
    slot = torch.where(first, ordinal.clamp(max=n_rows), n_rows).long()
    starts = torch.full((B, n_rows + 1), -1, dtype=torch.int32,
                        device=flags.device)
    steps = torch.arange(S, dtype=torch.int32,
                         device=flags.device).expand(B, S)
    # steps that are not FIRST all land in the dropped slot n_rows
    starts.scatter_(1, slot, steps)
    return starts[:, :n_rows].contiguous()


def _check_shapes(kind: str, dtype, D: int, block_q: int, block_k: int):
    """Raise on a dtype, head dim or block that no CUDA kernel of
    ``kind`` takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {dtype}; use float32 or "
                        "bfloat16")
    esize = torch.finfo(dtype).bits // 8
    if D > 128 or (D * esize) % 16:
        raise ValueError(f"head dim {D} unsupported: at most 128 and a "
                         "multiple of 16 bytes")
    if dtype == torch.bfloat16 and D % 16:
        what = {"fwd": "forward", "dq": "dQ", "dkv": "dK/dV"}[kind]
        raise ValueError(f"head dim {D} unsupported by the bf16 tensor-core "
                         f"{what}: a multiple of 16")
    if not (16 <= block_q <= 128 and block_q % 16 == 0):
        raise ValueError(f"block_q {block_q} unsupported: a multiple of 16 "
                         "up to 128")
    if not (KEY_TILE <= block_k <= 128 and block_k % KEY_TILE == 0):
        raise ValueError(f"block_k {block_k} unsupported: a multiple of "
                         f"{KEY_TILE} up to 128")


#: block sizes and head dims of the bf16 forward on wgmma
WGMMA_SIZES = (64, 128)


def fwd_kernel_for(dtype, block_q: int, block_k: int, head_dim: int) -> str:
    """The CUDA forward that :func:`flash_fwd` launches for these shapes,
    by shape alone: ``"wgmma"`` (``fwd_wgmma_kernel``: bf16 with block_q,
    block_k and D each in ``WGMMA_SIZES``), ``"mma"`` (``fwd_mma_kernel``:
    every other bf16 shape) or ``"scalar"`` (``fwd_kernel``: f32).  Raises
    on what no forward takes."""
    _check_shapes("fwd", dtype, head_dim, block_q, block_k)
    return _fwd_kernel(dtype, block_q, block_k, head_dim)


def _fwd_kernel(dtype, block_q: int, block_k: int, head_dim: int) -> str:
    """:func:`fwd_kernel_for`'s rule on shapes already checked."""
    if dtype == torch.float32:
        return "scalar"
    if all(x in WGMMA_SIZES for x in (block_q, block_k, head_dim)):
        return "wgmma"
    return "mma"


def _check_kernel_inputs(kind, q, k, v, metas, tables, grid, block_q,
                         block_k, extra=()):
    """Validate what the CUDA kernels take; returns (B, Hq, Hkv, Tq, Tk,
    D, rows, width)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,Hq,Tq,D), k and v (B,Hkv,Tk,D) expected, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    for t in (k, v, *extra[:1]):
        if t.dtype != q.dtype:
            raise TypeError(f"dtypes differ: {q.dtype} vs {t.dtype}")
    if k.shape[0] != B or k.shape[3] != D or Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    _check_shapes(kind, q.dtype, D, block_q, block_k)
    if Tq % block_q or Tk % block_k:
        raise ValueError(f"lengths {Tq}, {Tk} are not multiples of blocks "
                         f"{block_q}, {block_k}")
    for name, t in (("q", q), ("k", k), ("v", v),
                    *(("do", t) for t in extra[:1])):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    for t in extra[1:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, Tq) \
                or not t.is_contiguous():
            raise ValueError("lse and delta must be contiguous f32 "
                             "(B, Hq, Tq)")
    for t, T in zip(metas, (Tq, Tq, Tk, Tk)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B, T) \
                or not t.is_contiguous():
            raise ValueError("doc/pos must be contiguous int32 (B, T)")
    rows = Tk // block_k if kind == "dkv" else Tq // block_q
    for t in tables:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.shape[0] != B:
            raise ValueError("tables must be contiguous int32 with a "
                             "leading batch dim")
    if grid == "rect":
        idx, nvis = tables
        if idx.dim() != 3 or idx.shape[1] != rows \
                or tuple(nvis.shape) != (B, rows):
            raise ValueError(f"rect tables must be (B, {rows}, V) and "
                             f"(B, {rows}), got {tuple(idx.shape)} "
                             f"{tuple(nvis.shape)}")
        width = idx.shape[2]
    else:
        if any(t.dim() != 2 or t.shape != tables[0].shape for t in tables):
            raise ValueError("flat tables must be three (B, S) arrays")
        width = tables[0].shape[1]
    return B, Hq, Hkv, Tq, Tk, D, rows, width


def _launch(kind: str, name: str, q, k, v, q_doc, q_pos, kv_doc, kv_pos,
            tables, grid, block_q, block_k, scale, outs, do=None, lse=None,
            delta=None):
    """Check the inputs and launch one entry of the library (``kind`` a
    key of ``_KINDS``: ``"fwd_wgmma"`` is the forward's entry running
    ``fwd_wgmma_kernel``); the forward also gets its kind, dQ its
    sub-tile, dK/dV in bf16 its split plan and, for more than one group
    slice, its f32 slice workspace."""
    from ._build import doc_attention_lib

    entry = "fwd" if kind == "fwd_wgmma" else kind
    extra = () if do is None else (do, lse, delta)
    B, Hq, Hkv, Tq, Tk, D, rows, width = _check_kernel_inputs(
        entry, q, k, v, (q_doc, q_pos, kv_doc, kv_pos), tables, grid,
        block_q, block_k, extra)
    if kind == "fwd_wgmma" \
            and (kv_doc.data_ptr() % 16 or kv_pos.data_ptr() % 16):
        raise ValueError(f"{name}: kv_doc and kv_pos must be 16-byte "
                         "aligned (the wgmma forward copies them in bulk)")
    lib = doc_attention_lib()
    parts, slices = 1, 1
    if kind == "dkv" and q.dtype == torch.bfloat16:
        parts, slices = dkv_split_plan(B, Hkv, rows, Hq // Hkv, block_k,
                                       sm_count(q.device))
    need = lib.doc_attn_smem_bytes(_KINDS[kind], _DTYPE_CODE[q.dtype],
                                   block_q, block_k, D, parts, DQ_KEY_TILE)
    if need > _SMEM_LIMIT:
        raise ValueError(f"{name}: block_q {block_q}, D {D} need {need} "
                         f"bytes of shared memory (limit {_SMEM_LIMIT})")
    if grid == "flat":
        t0, t1, t2 = tables
        starts = run_starts(t2, rows)
    else:
        (t0, t1), t2, starts = tables, None, None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [ptr(q), ptr(k), ptr(v), ptr(do), ptr(q_doc), ptr(q_pos),
                ptr(kv_doc), ptr(kv_pos), ptr(t0), ptr(t1), ptr(t2),
                ptr(starts), ptr(lse), ptr(delta),
                *(ptr(o) for o in (*outs, None)[:2]),
                B, Hq, Hkv, Tq, Tk, D, block_q, block_k, rows, width,
                int(grid == "flat"), float(scale), _DTYPE_CODE[q.dtype],
                ctypes.c_void_p(stream)]
        if entry == "fwd":
            args.append(_KINDS[kind])
        elif kind == "dq":
            args.append(DQ_KEY_TILE)
        elif kind == "dkv":
            ws = None
            if slices > 1:
                ws = torch.empty((2, slices, B, Hkv, Tk, D),
                                 dtype=torch.float32, device=q.device)
            args += [parts, slices, ptr(ws)]
        code = getattr(lib, f"doc_attn_{entry}")(*args)
    if code != 0:
        msg = lib.doc_attn_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def flash_fwd(q, k, v, q_doc, q_pos, kv_doc, kv_pos, tables, *,
              scale: float, block_q: int = DEFAULT_BLOCK_Q,
              block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """Forward pass -> ``(o, lse)``.  ``tables`` is ``(kv_idx, kv_nvis)``
    for ``grid="rect"``, ``(fq_row, fq_col, fq_flags)`` for
    ``grid="flat"``."""
    tables = _check_grid(grid, tables)
    if _on_cpu(q, k, v, q_doc, q_pos, kv_doc, kv_pos, *tables):
        return flash_fwd_plain(q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                               tables, scale=scale, block_q=block_q,
                               block_k=block_k, grid=grid)
    B, Hq, Tq, D = q.shape
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"scale {scale} unsupported by the bf16 forward: "
                         "it must be positive")
    wgmma = _fwd_kernel(q.dtype, block_q, block_k, D) == "wgmma"
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    with obs.span("doc_attention.fwd"):
        _launch("fwd_wgmma" if wgmma else "fwd", "flash_fwd", q, k, v,
                q_doc, q_pos, kv_doc, kv_pos, tables, grid, block_q,
                block_k, scale, (out, lse))
        if wgmma:
            obs.count("doc_attention.fwd_wgmma")
    flash_fwd.launches += 1
    flash_fwd.wgmma_launches += wgmma
    return out, lse


flash_fwd.launches = 0
#: the launches that went to fwd_wgmma_kernel (the rest of ``.launches``
#: to fwd_mma_kernel or, in f32, fwd_kernel)
flash_fwd.wgmma_launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc, kv_pos,
                 tables, *, scale: float, block_q: int = DEFAULT_BLOCK_Q,
                 block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """dQ pass; ``tables`` as in :func:`flash_fwd` (the same q-block
    rows drive both)."""
    tables = _check_grid(grid, tables)
    if _on_cpu(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc, kv_pos,
               *tables):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_doc, q_pos,
                                  kv_doc, kv_pos, tables, scale=scale,
                                  block_q=block_q, block_k=block_k,
                                  grid=grid)
    dq = torch.empty_like(q)
    with obs.span("doc_attention.dq"):
        _launch("dq", "flash_bwd_dq", q, k, v, q_doc, q_pos, kv_doc, kv_pos,
                tables, grid, block_q, block_k, scale, (dq,), do=do,
                lse=lse, delta=delta)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc, kv_pos,
                  tables, *, scale: float, block_q: int = DEFAULT_BLOCK_Q,
                  block_k: int = DEFAULT_BLOCK_K, grid: str = "rect"):
    """dK/dV pass over the *reverse* map: ``(q_idx, q_nvis)`` for
    ``grid="rect"``, ``(rq_row, rq_col, rq_flags)`` for ``grid="flat"``
    (rows are KV blocks, cols the visiting Q blocks)."""
    tables = _check_grid(grid, tables)
    if _on_cpu(q, k, v, do, lse, delta, q_doc, q_pos, kv_doc, kv_pos,
               *tables):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_doc, q_pos,
                                   kv_doc, kv_pos, tables, scale=scale,
                                   block_q=block_q, block_k=block_k,
                                   grid=grid)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with obs.span("doc_attention.dkv"):
        _launch("dkv", "flash_bwd_dkv", q, k, v, q_doc, q_pos, kv_doc,
                kv_pos, tables, grid, block_q, block_k, scale, (dk, dv),
                do=do, lse=lse, delta=delta)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0
